#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port on one GPU.

    python3 chip_smoke.py            # every phase (what the checks run)
    python3 chip_smoke.py --quick    # build, ptxas, one check per case,
                                     # the generate phase at 2 blocks
    python3 chip_smoke.py --seed-sweeps  # VGG at lr 0.05 and 0.01 and
                                         # the deep AE's card-vs-CPU cut
                                         # from several initial draws

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU. It
imports `deeplearning4j_tpu_torch` (never JAX or `deeplearning4j_tpu`) and:

1. prints the card (`nvidia-smi` name and power limit) and the versions;
2. builds every kernel of the serving and training paths from
   `deeplearning4j_tpu_torch/csrc/` with nvcc (sm_90a), one nvcc per source,
   all started together, and reports the registers and spills of each TMA
   body (D = 64, 128) and of the f32 3xTF32 bodies, forward, dK/dV and dQ
   (D = 32, 64, 128); a spill fails the run;
3. holds the flash-attention forward kernel against its plain PyTorch
   version on the card, at the serving shape (contiguous inputs, and the
   strided views of one fused qkv projection that the serving path passes),
   at the train step's shape with lse on those views, and at a ragged
   shape; in f32 (the 3xTF32 body, atol = rtol = 1e-4 on o and lse) at
   [8, 512, 16, 128] contiguous and on qkv views, at the CLI
   char_transformer's [32, 256, 4, 32] and at ragged S with D = 64 and 100;
   and times the kernel, the plain version and the
   one PyTorch call that computes the same function by CUDA-graph replay
   (device time, no host launch cost), the wrapper's eager call
   (`call_ms`), and the bound (the least time the card could take);
4. does the same for the three kernels of the fused attention backward
   (delta, dK/dV, dQ): bf16 causal at the training shape on qkv views, f32
   at [8, 512, 16, 128] causal and not (contiguous) and causal on qkv views,
   f32 at a ragged S with D = 100, and bf16 at ragged S; checks
   `FlashAttentionFunction`'s
   gradients against autograd through the plain forward, both taken with
   respect to the fused qkv projection whose views they read; the yardstick is
   the backward of `scaled_dot_product_attention` (its forward plus
   backward, less its forward), beside the sum of the three f32 kernels;
   then holds the f32 forward (o, lse), delta, dK/dV and dQ to their plain
   versions at the JAX package's own f32 shapes and tolerances ((2, 64, 2,
   8) and (1, 128, 2, 16), causal and not; 2e-5 forward, 1e-5 backward)
   and reports each max error (`f32_reference_shapes` lines; a miss fails
   the run);
5. serves the full-width charTransformer (vocab 256, d_model 2048, 8 blocks,
   16 heads, seq 512, bf16 compute, random weights from a seed) through
   `MultiLayerNetwork.serve` to 4 concurrent POST /v1/predict requests,
   answered by replays of the infer cache's CUDA graphs (captured by
   `net.warmup` before the run), checks each answer against a direct
   `net.output`, checks the flash path against the plain attention path in
   f32 and times both f32 network outputs, times the coalesced batch's
   forward through the cache and eagerly in turns, and checks that every
   forward pass launched the flash kernel once per attention layer (a
   replay counts what its capture launched); then generates with it
   (`generate` phase, GEN): `warmup_generate` captures the decode table's
   graph and a B = 1 prefill graph per prompt bucket, and a 4-slot
   `ContinuousBatcher` answers 4 POST /v1/generate requests of 128 tokens
   from 4 clients (half greedy, half at 0.8); it checks every stream, that
   each admission launched the flash kernel once per block and that
   serving captured nothing new; times the captured and eager decode step
   (each profiled once) and each prefill bucket beside the step's bounds;
   and checks (a) the cached decode against the eager `nn/decode.py` loop
   (tokens, keys, state), (b) teacher-forced decode logp against the
   re-forward, and greedy tokens against it in f32 at 2 blocks, (c) the
   flash forward at B = 1 and every prefill bucket against its plain
   version, (d) the card's threefry keys and uniforms against the CPU's
   bit for bit, (e) `CharLSTM.generate == sample` at BASELINE config 1's
   widths, and times the forward kernel at the warmed buckets; the option
   passes serve the same requests at K = 8, paged, with the prefix cache
   and speculatively (GEN_SPEC: a char-LSTM draft, `spec_k` = 4, dense and
   paged; each stream bitwise the K = 1 pass's or its first divergence
   within 2e-2 max|logp|; a verify against 4 decode steps; the verify's
   and a draft step's device times), then speculative decoding in f32 at
   2 blocks (greedy, bitwise) and on the char-LSTM target with a cloned
   and a disagreeing draft (SPEC_LSTM, bitwise);
6. trains the same network with `MultiLayerNetwork.fit` (the JAX package's
   flagship training conf, bench.py:558-567: Adam, sparse labels, fused
   updater, fused attention backward, bf16 compute over f32 weights) for
   TRAIN_STEPS one-step calls on one batch of 32 x 512 tokens, on two
   networks from the same weights in turns: the default path (one captured
   CUDA graph a step, replayed) and the eager one (`use_step_cache` and
   `use_infer_cache` off); checks that the scores are finite and fall, that
   each step launched the forward kernel and each backward kernel once per
   attention layer on both paths, that the step was captured once, and
   that the two paths' params agree within bf16 (2e-2 of max|param|);
   traces one more step of each with `torch.profiler` (device time by
   kernel, idle share), and checks the fused backward's gradients against
   the recompute path in f32 (the f32 backward kernels, once per attention
   layer);
7. holds the fused LSTM cell kernel against its plain version at the
   char-LSTM bench shape (f32; on the row-block views of one W; bf16), at
   the CLI's ragged shape and at a tiny ragged one (each in f32 and bf16),
   timed beside its plain version, `torch.lstm_cell` and its bound, and
   one [256, 64, 256] layer (64 launches) beside cuDNN's `nn.LSTM`;
8. trains the bench's 4-layer char-LSTM (bench.py:252-261: vocab 50, embed
   and hidden 256, seq 64, batch 256, bf16 output layer, SGD with momentum)
   for LSTM_STEPS one-step `fit` calls on the word corpus of bench.py:1706,
   captured and eager in turns as in 6, checks that the scores fall, that
   every forward launched the cell kernel 4 * 64 times and that the two
   paths agree within bf16, profiles one more step of each, holds the
   kernel path to the hoisted scan in f32 (outputs, gradients), and times
   the fused and scan paths' step and `output`, each captured and eager;
9. stops a checkpointed char-LSTM `fit` (the bench's widths, four
   batches) by SIGTERM after two batches, reruns it from its checkpoint,
   and holds it to two uninterrupted runs (`checkpoint` line);
10. runs the CLI north star in process (bench.py:1716-1719: `train --zoo
   char_lstm:layers=4,hidden=128` over the corpus as text windows of 32),
   the same with `--checkpoint-dir` in batches of 256, then `predict`,
   `test` and `generate` (greedy and at 0.8, held to the cached path
   called directly, then with the ported options and with the checkpoint
   as its own `--draft`) on its checkpoint;
11. holds the embedding-row scatter-add kernel against its plain version at
   the word2vec step's shapes (syn1 from the bench vocabulary's Huffman
   points, syn0, syn1neg), a GloVe bias (D = 1), tiny ragged cases with
   duplicate and out-of-range indices at D = 5 and D = 1, bf16, every
   update of syn1's shape into one row, syn1's shape with uniform indices
   and a ragged D = 30: exact on integer-valued inputs, within the
   any-order summation bound on random ones, timed beside its plain
   version, `index_add_` and its bound;
12. trains the bench's Word2Vec at full size (bench.py:368-385: vocab
   10,000, 1.2M zipf tokens, vector 128, window 5, negative 5, HS, batch
   32,768, 3 epochs) through `Word2Vec.fit`: words/s as bench.py:391
   computes it, step time, 3 scatter launches a step and profiled steps;
   then one epoch of the same with per-word AdaGrad, whose tables stay
   finite and whose loss on a fixed batch falls (the bench's SGD diverges,
   in the JAX package too);
13. trains Word2Vec, ParagraphVectors and GloVe on the two-cluster corpus of
   tests/test_embeddings.py and passes its similarity assertions, each
   launching the scatter kernel once per gather of every step;
14. `datasets_serve_api`: writes the 60,000-image MNIST stand-in as IDX
   files, reads them with the native reader (built with g++) and in Python
   (array-equal, both timed), trains bench.py:416's 784-512-512-10 MLP on
   them through the CLI (`train --zoo mlp:hidden=512x512 --input
   mnist:60000`, batch 8,192, 5 epochs, read natively through MNIST_DIR)
   and `test`s it (accuracy at least chance + 0.4); loads `iris:` and
   `cifar10:` and trains an Iris net built with `list_builder` by SGD;
   serves the SLICE charTransformer with `batching=True` and then
   `batching=False` to 4 concurrent requests of mixed priority under a
   default deadline (flash launches 8 a flush, then 8 a request; answers
   within 2e-2 of `net.output`; per-priority request counts; no capture
   after the int32 warm-up), then its checkpoint through the CLI's `serve
   --shapes` in a subprocess (no capture after the warm-up, drained on
   SIGTERM); takes a CheckpointListener's asynchronous saves during
   captured `fit` steps at SLICE's width (2 blocks) and holds each
   array-equal to a synchronous save of its step's params (the snapshot's
   stall timed); and round-trips `params_flat` / `set_params_flat`, after
   which the next step replays;
15. `conv_nets` (CONV_*): bench.py's LeNet-5 (`_mixed`, batch 4,096, the
   60,000-image MNIST stand-in) and VGG-CIFAR10 (`_mixed`, width 64, batch
   512, lr 0.01, the CIFAR stand-in) through `MultiLayerNetwork.fit`:
   captured and eager steps in turns (median step ms, samples/s, idle share from one
   profiled step, whose device ms by kind of kernel are the
   `conv_profile_*` lines), held within 2e-2 of max|param| of the captured
   program run uncaptured (the BatchNorm EMA too) and of each other (a
   BatchNorm net one step from the same params, EMA included, since its
   trajectories part), the ragged tail padded into the batch's bucket against an
   unpadded uncaptured step, `output` timed and read after a step with no
   new capture, epochs of the captured net with no capture under traffic
   and the held-out accuracy (at least chance + 0.4); `conv_dropout`:
   LeNet with dropout 0.5, the card's masks bitwise the CPU's, captured
   against eager, and the graph drawing its masks from its key input;
   `conv_f32`, in a child process with PyTorch's default (TF32) flags: the
   CLI's train/predict/test on `mnist:` and `cifar10:` in f32, the card's
   LeNet output within 1e-4 relative of the CPU port's (a plain
   `F.conv2d` under those flags beside it), the f32 VGG's captured and
   eager steps each within 1e-3 of max|leaf| of the CPU port's from the
   same params (EMA included; each conv against float64 beside them),
   deterministic against default cuDNN
   algorithms, and a checkpointed LeNet `fit` stopped by SIGTERM
   after 2 of 4 batches that resumes bitwise equal to an uninterrupted
   one;
16. `pretraining` (PRE_*; `--only-pretraining` runs it alone, with no
   kernel build and no last line): `pretrain_deep_ae`, the Curves net of
   Hinton & Salakhutdinov (2006) at `zoo.deep_autoencoder()`'s widths on
   20,000 stand-in curves at full batch (10 pretraining and 20 CG
   iterations) through `fit_deep_autoencoder`,
   captured and with its programs uncaptured (bitwise after each layer's
   pretraining, the unroll and the CG finetune; MSE below its init; JAX's
   MSE criteria on JAX's test net), each layer's and the CG run's replay
   timed, probes and host reads an iteration, one profiled pretrain run
   and CG run (device ms by kind: GEMM, threefry int64, elementwise,
   reductions), the card against the CPU port on a 2,000-row cut with a
   5-iteration CG finetune (gated at ten times the CPU's own gap under a
   1e-7 move of its inputs), and
   the CLI recipe; `pretrain_dbn`, `zoo.dbn(784, [500, 500, 2000], 10)`
   (Hinton, Osindero & Teh 2006) over 20,000 rows of the MNIST stand-in in
   [0, 1] in batches of 10,000 through `fit` (batch 1 bitwise its programs
   uncaptured, held-out accuracy at least chance + 0.4, the card's Gibbs
   uniforms bitwise the CPU's, its sample's flips beside the near-ties),
   ms a batch and a layer iteration, the draw share, the cut against the
   CPU, and the CLI; `solvers`, bench.py's MLP 784-512-512-10 on 8,192
   rows with GD, CG and LBFGS (6 iterations) and HF (3, CG 32): captured
   bitwise its program uncaptured, scores falling, each iteration's probes
   those of the eager `backtrack`, HF one graph a run, a Gauss-Newton
   product against dense M'Mv;
17. `data_parallel` (DP_*; `--only-data-parallel` runs it alone, with no
   last line, and the full run runs it so, in a child process): an NCCL
   group of one rank, then bench.py:546-569's flagship
   training entry point, `DataParallelTrainer(mode="sync")`, at its conf
   (the train phase's `train_conf`, TRAIN_LR) on 32 x 512 ids from
   RandomState(0): two eager trainer steps, then two captured ones
   (one CUDA graph, the NCCL all-reduce inside it) held to them bitwise,
   step 1 against one `MultiLayerNetwork.fit` call (bitwise, or the first
   differing leaf and a gap within a hundredth of how far that `fit` moved
   the params, so a skipped or wrong update fails), ZeRO-1 bitwise
   sync after two steps, 8 launches of each of rows 1-4 a step (host
   counts and a profiled replay), the collectives issued inside the
   captures, no capture under traffic; the step's event-timed median
   beside `fit`'s, tokens/s, the profiled replay's idle share (its device
   time over its own wall time), device ms by kind (GEMM, casts,
   elementwise, attention, NCCL), capture s, pool bytes and peak memory;
   then, in a child process (`--dp-ckpt-child DIR`), a checkpointed
   trainer `fit` over 4 batches (the flagship at 2 blocks) stopped by a
   SIGTERM after 2 and resumed bitwise equal to an uninterrupted one
   (write s); then the bench's char-LSTM (captured vs eager bitwise, 256
   cell launches a step) and VGG-CIFAR10 (width 64, batch 512; captured vs
   eager bitwise, the EMA after one step against `fit`'s, within a
   hundredth of how far that step moved it) through the
   trainer, each timed. The masked (remainder) steps never run at one
   rank; the CPU tests hold them at two;
18. `tensor_parallel` (TP_*; `--only-tensor-parallel` runs it alone, with
   no last line, and the full run runs it so, in a child process): the
   flagship (the data_parallel phase's conf and batch) through
   `DataParallelTrainer(plan=ShardPlan(plan_mesh({"batch": 1, "model":
   1})))`, held bitwise to the sync trainer for 2 steps, rows 1-4 8 a
   step (host counts and a profiled replay), step ms, tokens/s, bytes of
   params and moments; rows 1-4 at the plan step's per-rank shapes [32,
   512, H/M, 128] for M = 2 and 4 (bf16, causal, qkv views) against their
   plain versions, beside their bounds and SDPA; ring and Ulysses
   attention (16 heads of 128, S = 512), the pipeline and MoE at d_model
   2048 against their dense references. Under `torchrun --nproc-per-node
   4 chip_smoke.py --only-tensor-parallel` (four cards): the one-rank plan
   run on rank 0, then the flagship at 1 x 4, 2 x 2 and 2 x 2 with ZeRO-1,
   each rank's bytes, step ms, tokens/s, NCCL device ms and the
   collectives inside the capture (4 all-reduces a block, the gradient's
   and the score's), scores within TP_SCORE_RTOL of the one-rank run's
   and, after the same 2 steps, its params and Adam moments within the
   TP_PARAM_* and TP_MOMENT_RTOL gates, which a control run on half the
   batch (a dropped gradient all-reduce) must break; a
   2 x 2 sharded checkpoint (2 blocks) restored on 1 x 4 bitwise; ring,
   Ulysses, the pipeline and MoE over the four ranks (S = 4 x 512).
19. `serve_mesh` (SM_*; `--only-serve-mesh` runs it alone, with no last
   line, and the full run runs it so, in a child process): the flagship
   from seed 0, its `init` timed and its first three layers' params held
   to the same draws on the CPU (uniform leaves bitwise, the positional
   table within 4 ulps); `output` under the 1-D mesh (`--mesh all`) and
   under batch=1,model=1 bitwise the single-card cache's; the dense,
   paged, K = 8, prefix-hit and speculative passes under batch=1,model=1
   token-identical to the single-card passes, one flash launch a block an
   admission, nothing captured while serving; the 1-D mesh's generation
   on the "single" programs (no capture); latency, tokens/s and per-rank
   bytes; row 1 at the per-rank prefill shapes [1, 64|256, 8|4, 128] and
   the served shape against its plain version, beside its bound and
   SDPA. Under `torchrun --nproc-per-node 4 chip_smoke.py
   --only-serve-mesh` (four cards): 1 x 4, 2 x 2 and
   4 x 1 against rank 0's one-card run: bf16 output within SM_BF16_REACH
   times one card's bf16 gap to the f32 net (its gap to one card and
   2e-2 max|o| reported), which two controls at 1 x 4 (partial products
   not all-reduced; `Wo` rows of the wrong heads) must break,
   greedy streams' first divergence within 2e-2 max|logp|
   (teacher-forced), the CPU test's small f32 net's greedy tokens
   identical, and the per-rank K/V bytes 1/M of one card's.
20. `serve_precision` (SP_*; `--only-serve-precision` runs it alone, with
   no last line, and the full run runs it so, in a child process): the
   flagship from seed 0 with f32 compute served under f32, bf16 and int8
   (`set_serve_precision`, the default calibration), then f32 again:
   8 flash launches a forward, the 3xTF32 body under f32 and the TMA bf16
   body under bf16 and int8 (profiled), every int8 q and scale bitwise
   numpy's quantization of the card's params, the flip back bitwise and
   uncaptured, all three policies in `programs_summary`; per policy the
   replay's ms, the pool and param bytes and the accuracy delta against
   the charTransformer's budgets (reported); generation under bf16 and
   int8 (SM's 4-slot batcher, 4 prompts of 40-250 ids, 32 greedy tokens:
   nothing captured while serving, 8 flash launches an admission,
   tokens/s, the decode step's device ms); the store: the cold int8
   calibration timed, a second process (`--sp-child`) loading the
   artifact (no calibration, its output bitwise) and serving a prefix
   entry this process wrote (a disk hit, the same tokens), a corrupted
   artifact evicted and calibrated again; the CLI's `warmup --precision
   int8 --compile-cache D` then `serve --precision int8 --compile-cache D`
   (a subprocess) and 2 POST /v1/predict (its weights from the artifact,
   `/v1/stats` int8, nothing captured under traffic); the bench's
   char-LSTM with f32 compute under bf16 and int8 (`lstm_cell_bf16_kernel`
   4 x 64 launches a forward, within SP_LSTM_TOL of the same policy's
   scan); `error_budget_report(small=False)` within every budget.
21. `fleet` (FL_*; `--only-fleet` runs it alone, with no last line, and the
   full run runs it so, in a child process): each tile variant of the
   flash forward (`FL_TILE_CASES`: bf16 128x128 and 128x64 at the train and
   prefill shapes and D = 64, f32 64x32 and 64x64 at [8, 512, 16, 128]
   causal and not and at D = 64) against the plain version (bf16 2e-2 of
   max|o|, f32 1e-4), its replay, plain and SDPA ms and bound; `tune
   --groups attention` of the f32-compute flagship (both f32 tiles
   launched), then `tune` of the bf16 flagship at SLICE's widths cut to
   FL's 2 blocks into an empty store, in process (both bf16 tiles
   launched; candidates, winners, seconds, the serve group's pool bytes a
   row target; a candidate the card cannot hold fails its capture, counted
   and skipped), then again in a fresh process (inherited: fresh_tunes 0,
   source disk); `serve --replicas 2 --min-replicas 1 --max-replicas 2` on
   that store (each replica's `tuning` block: the table, fresh_tunes 0, the
   card's kind), 4 requests through the router bitwise an in-process
   `net.output` with the same table, a burst from 8 threads (rows/s), the
   router's and a replica's /metrics parsed, the replicas' flash launches
   (`kernel_launches` of /v1/stats), one replica SIGKILLed and respawned
   (answers bitwise after it), the drain to exit 0; an `agent` on an empty
   store and `serve --agent` with its cache server on the first store: the
   replica inherits the table over the cachesync wire (a fetch hit) and
   answers bitwise.
22. `text_trees` (TT; `--only-text-trees` runs it alone, with no last
   line, and the full run runs it so, in a child process): an SST-sized
   synthetic treebank from seed 0 (8,544 training and 2,210 held-out
   s-expressions of 5 to 56 tokens over the bundled lexicon's and tagger's
   words, each node labelled with the 5-way bucket of its span's lexicon
   score); the RNTN at Socher et al.'s width (dim 25, 5 classes, max_nodes
   128, AdaGrad lr 0.05, l2 1e-4) for 30 full-batch epochs, each step one
   captured graph (capture s, pool bytes, step ms, the last step profiled:
   kernels a step, idle share), an eager model's steps from the same
   state (first loss equal), held-out root and all-node accuracy and
   RNTNEval against the majority shares, the scatter kernel at the leaf
   gradient's shape against its plain version, and the card's loss and
   params after 1 epoch of a 512-tree subset within TT's cpu_rel_tol and
   cpu_param_tol of the CPU port's (params where the first gradient is
   above rounding noise); the recursive autoencoder for 10 epochs alike; the chunk
   parser with the lexicon on 256 sentences, its Viterbi on the card,
   tags and trees equal to the CPU's; a window classifier (the bench MLP
   on Word2VecDataSetIterator batches of a small port Word2Vec) whose
   score falls. Its scatter launches join the scatter row's.
23. `scaleout_clustering` (SC; `--only-scaleout-clustering` runs it alone,
   with no last line, and the full run runs it so, in a child process):
   the distributed Word2Vec at the bench's widths with AdaGrad, 4 BSP
   workers, 1 epoch (words/s beside the single-process port's on the same
   corpus, scatter launches 3 a step, a profiled tenth of the corpus for
   the host share, quality on embed_quality's corpus); the distributed
   GloVe on that corpus for 2 epochs (loss falls, 4 launches a step);
   the scatter kernel at a job's syn0, syn1, syn1neg, w and b shapes
   against its plain version; `distributed_word_count` equal to a serial
   count; k-means at 1,000,000 x 128, k = 256, through the fast path and
   the strategy framework (ms an iteration, iterations, peak memory; a
   20,000-point subset's seeds, iterations and assignments equal to the
   CPU port's); exact t-SNE on 10,000 MNIST stand-in rows for 300
   iterations (KL falls; P and 10 iterations of a 500-row subset against
   the CPU port); meanwhile, in their own processes, Barnes-Hut t-SNE on
   2,000 rows for 100 iterations on the host (the exact KL falls, and
   falls along its gradient; the full run starts it at its own start), the
   parameter server's BSP and
   async fleets of 3 ps_worker processes on the card (4 rounds of the
   Iris MLP; the scores fall; the straggler exits last) and a LocalLauncher
   fleet of 2 gloo ranks that all-reduce from the exported env; a
   BlobModelSaver round trip, bitwise. Its scatter launches join the
   scatter row's.

24. `analysis_ui` (AN; `--only-analysis-ui` runs it alone, with no last
   line, and the full run runs it so, in a child process): `analyze
   --fail-on error --format json` on the card (the port's lint and the
   small zoo's programs, each run once under the recording dispatch mode;
   exit 0, no error); `audit_zoo_programs` at the zoo's published widths
   (charTransformer d_model 128, 2 blocks, S 256; char-LSTM hidden 256)
   with the scores rule at S = 256, no error; the full-width
   charTransformer's `output` under the bf16 serve policy (its
   dtype-promotion warns printed); `audit_attention_structure(S=1024)`
   through the f32 forward and fused backward kernels (rows 1-4, no
   finding, their launches printed; `analyze` runs the decode and
   speculative-parity audits, once); the UI
   server's `/api/tsne` on 2,000 rows on the card against the same route
   on the CPU (20 iterations: KL within 1e-4, coordinates within ten
   times the CPU run's own gap under a one-ulp change of its input) and the
   route's default 300 iterations timed; a `Tracer` trace of one
   full-width char-LSTM `output` that names `lstm_cell_f32_kernel`; the
   plotter where matplotlib is installed (skipped with the reason where it
   is not). Its launches join rows 1-5.

Slice 27's public names ride on earlier phases: the serve phase holds
`f1_score` to `evaluate`'s F1 and two batches `evaluate`d into one
`Evaluation` to one `evaluate` over both (same forwards, equal counts;
their flash launches join row 1), prints `program_memory()` of the infer
cache (and the train phase of the step cache), and reads the breaker's
gauge in `/metrics` against `CircuitBreaker.state_code`; the
`data_parallel` VGG trainer's state goes through `save_sharded_async`
and `join_async`, loaded back bitwise equal to `save_sharded`'s; and
`datasets_serve_api` pulls the MNIST stand-in's batches through one
`PrefetchIterator` from two threads, each batch delivered once.

The full run starts each late phase's child process while the phase
before it runs (`Children`), so the child's start-up costs no wall time.

Each phase prints one JSON line (with `t_s`, the seconds since its
process started or, in a child, since its turn came); then a
`phase_seconds` line with each phase's seconds on the host clock, a line
with every kernel's numbers, the card's line, and last `{"ok": true,
"device": {...}}`. Any failure exits
non-zero before the last line. Without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, dense): FLOP/s by operand type, HBM B/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
#: f32 attention products on the tensor cores as 3xTF32 (three TF32
#: products of 495 TFLOP/s each): the least time for an f32 product, where
#: PEAK_FLOPS["float32"] (FMAs on the CUDA cores) is kept as `fma_bound_ms`
F32_3XTF32_FLOPS = 495e12 / 3

SLICE = dict(vocab=256, d_model=2048, n_blocks=8, n_heads=16, seq=512)
REQUESTS, REQUEST_ROWS = 4, 2
TRAIN_ROWS, TRAIN_STEPS = 32, 5
# The zoo's lr is 1e-3. `fit` restarts Adam from zero moments on every call,
# as the JAX package does, so each one-iteration call moves every weight by
# about lr (Adam's first step is lr * g / (|g| + eps)). At d_model 2048 on
# this batch the score rises with TRAIN_LR at 1e-4 and 1e-3 and falls at
# 1e-5 (on an H100; PERF.md). The JAX package's `fit` rises alike at the
# zoo's lr (tests/test_torch_training.py, at d_model 512 and 8 blocks).
TRAIN_LR = 1e-5


class SmokeFailure(RuntimeError):
    pass


#: this process's clock origin: its start, or a child's turn (`wait_turn`)
_T0 = [time.perf_counter()]
#: the full run's phases in order, each with its seconds on the host clock
#: (`phase_clock`), printed on the `phase_seconds` line
PHASE_SECONDS: dict = {}


def emit(obj) -> None:
    """Print one JSON line; a phase line gets `t_s`, the seconds since
    this process started (a child: since its turn came)."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0[0]}
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase_clock(name: str):
    """Record the seconds a phase of the full run takes (PHASE_SECONDS)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one fn() call: `iters` calls captured into one CUDA
    graph, the graph replayed `replays` times between CUDA events. Replay
    launches the kernels back to back with no host work between them, so
    this is the kernels' own time, without the Python and launch cost that
    `cuda_ms` includes."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (iters * replays)
    del graph
    return ms


def roofline_ms(flops, nbytes, rate):
    """(max(operations / rate, bytes / HBM rate) in ms, which of the two
    bounds it)."""
    t_ops = flops / rate
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def product_bounds(flops, nbytes, dtype_name):
    """(bound_ms, bound_by, fma_bound_ms) of attention products: bf16 at
    the bf16 tensor-core rate; f32 at the 3xTF32 rate, with the bound at
    the rate of f32 FMAs beside it (None for bf16)."""
    if dtype_name == "bfloat16":
        return roofline_ms(flops, nbytes, PEAK_FLOPS["bfloat16"]) + (None,)
    fma_ms, _ = roofline_ms(flops, nbytes, PEAK_FLOPS["float32"])
    return roofline_ms(flops, nbytes, F32_3XTF32_FLOPS) + (fma_ms,)


def attention_bound_ms(b, s, h, d, dtype_name, causal, with_lse):
    """(bound_ms, bound_by, fma_bound_ms) of one forward: the scores and
    P.V products (halved when causal), q, k, v read once, o (and lse)
    written once."""
    size = 2 if dtype_name == "bfloat16" else 4
    flops = 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)
    nbytes = 4.0 * b * s * h * d * size + (4.0 * b * h * s if with_lse else 0)
    return product_bounds(flops, nbytes, dtype_name)


def bwd_bound_ms(name, b, s, h, d, dtype_name, causal):
    """(bound_ms, bound_by, fma_bound_ms) of one backward kernel: each input
    read once, each output written once. dK/dV: four products of [S, S, D]
    per head (QK^T, dO V^T, P^T dO, dS^T Q); dQ: three (QK^T, dO V^T,
    dS K); both halved when causal. Delta: o and dO read, one f32 per row
    written; it multiplies no matrices, so its operations stay at the rate
    of its dtype's FMAs."""
    size = 2 if dtype_name == "bfloat16" else 4
    elems = float(b * s * h * d)
    rows = 4.0 * b * h * s                     # one f32 per (b, h, row)
    half = 0.5 if causal else 1.0
    if name == "flash_bwd_delta":
        flops, nbytes = 2.0 * elems, 2 * elems * size + rows
        bound = roofline_ms(flops, nbytes, PEAK_FLOPS[dtype_name])
        return bound + (bound[0] if dtype_name == "float32" else None,)
    if name == "flash_bwd_dkv":
        flops = 8.0 * b * h * s * s * d * half
        nbytes = 6 * elems * size + 2 * rows
    else:
        flops = 6.0 * b * h * s * s * d * half
        nbytes = 5 * elems * size + 2 * rows
    return product_bounds(flops, nbytes, dtype_name)


def qkv_views(qkv, h, d):
    """q, k, v as nn/layers/attention.py builds them from one fused
    [B, S, 3 * H * D] projection: views with sequence stride 3 * H * D."""
    b, s = qkv.shape[:2]
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    check(q.stride(1) == 3 * h * d, f"q strides {q.stride()}")
    return q, k, v


def bwd_inputs(torch, kernels, gen, b, s, h, d, dt, causal, view):
    """The fused qkv projection (None unless `view`), q, k, v (its strided
    views when `view`, as the attention layer passes them), dO, and the
    forward kernel's o and lse on them."""
    qkv = None
    if view:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dt)
        q, k, v = qkv_views(qkv, h, d)
    else:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    o, lse = kernels.flash_attn_fwd(q, k, v, causal, with_lse=True)
    return qkv, q, k, v, do, o, lse


def bwd_close(torch, got, want):
    """(max |got - want|, ok) at the stated tolerance: f32 outputs atol =
    rtol = 1e-4; bf16 outputs max |got - want| <= 2e-2 * max |want| (both
    are rounded to bf16 once, from f32 sums taken in different orders)."""
    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.float32:
        ok = bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4))
    else:
        ok = err <= 2e-2 * want.float().abs().max().item()
    return err, ok


def bwd_check(torch, kernels, q, k, v, do, o, lse, causal):
    """Each backward kernel against its plain version on the same inputs
    (dK/dV and dQ both take the plain delta); returns {kernel:
    (max_abs_err, ok)}."""
    out = {}
    delta = kernels.flash_bwd_delta_reference(o, do)
    out["flash_bwd_delta"] = bwd_close(torch,
                                       kernels.flash_bwd_delta(o, do), delta)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    wk, wv = kernels.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    ek, okk = bwd_close(torch, dk, wk)
    ev, okv = bwd_close(torch, dv, wv)
    out["flash_bwd_dkv"] = (max(ek, ev), okk and okv)
    out["flash_bwd_dq"] = bwd_close(
        torch, kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal),
        kernels.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    return out


def bwd_rel_errors(torch, kernels, q, k, v, do, o, lse, causal):
    """{kernel: max |got - want| / max |want|} of each backward kernel
    against its plain version (dK/dV: the larger of its two outputs)."""
    delta = kernels.flash_bwd_delta_reference(o, do)

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    wk, wv = kernels.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    return {"flash_bwd_delta": rel(kernels.flash_bwd_delta(o, do), delta),
            "flash_bwd_dkv": max(rel(dk, wk), rel(dv, wv)),
            "flash_bwd_dq": rel(
                kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                kernels.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               causal))}


def grad_function_check(torch, kernels, qkv, h, d, do, causal):
    """`FlashAttentionFunction` (forward kernel with lse, then delta, dK/dV
    and dQ) against autograd through `flash_attention_reference`, both on
    q, k, v views of one fused projection as the train step passes them,
    with gradients taken with respect to the projection; (max_abs_err over
    its dq, dk and dv parts, ok) at the bf16 tolerance, per part."""
    def grad(fn):
        leaf = qkv.detach().clone().requires_grad_()
        (g,) = torch.autograd.grad(fn(*qkv_views(leaf, h, d), causal), leaf,
                                   do)
        return g.split(h * d, dim=-1)

    got = grad(lambda q, k, v, c: kernels.flash_attention(q, k, v, c,
                                                          fused_bwd=True))
    want = grad(kernels.flash_attention_reference)
    torch.cuda.synchronize()
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    ok = all(e <= 2e-2 * w.float().abs().max().item()
             for e, w in zip(errs, want))
    return max(errs), ok


def sdpa_backward_ms(torch, q, k, v, do, causal):
    """The library yardstick for the whole fused backward: one
    `scaled_dot_product_attention` forward plus its backward, less the
    forward alone, each by CUDA-graph replay, at the same inputs."""
    import torch.nn.functional as F

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    gt = do.transpose(1, 2)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return torch.autograd.grad(out, (qt, kt, vt), gt)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

    return graph_ms(fwd_bwd) - graph_ms(fwd)


BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq")


def bwd_case_rows(torch, kernels, gen, case, phase="bwd_kernel"):
    """One backward case (b, s, h, d, dtype, causal, view): each of the
    three kernels against its plain version, timed beside its plain
    version, its bound and SDPA's whole backward (delta also beside
    `vecdot`); with `view`, `FlashAttentionFunction`'s grads against
    autograd of the plain forward. Emits each kernel's row and returns
    {kernel: row}; a disagreement fails the run."""
    b, s, h, d, dt, causal, view = case
    qkv, q, k, v, do, o, lse = bwd_inputs(torch, kernels, gen, b, s, h,
                                          d, dt, causal, view)
    results = bwd_check(torch, kernels, q, k, v, do, o, lse, causal)
    rel = bwd_rel_errors(torch, kernels, q, k, v, do, o, lse, causal)
    dname = str(dt).replace("torch.", "")
    grad_err = grad_ok = None
    if view:
        grad_err, grad_ok = grad_function_check(torch, kernels, qkv, h, d,
                                                do, causal)
    library_ms = sdpa_backward_ms(torch, q, k, v, do, causal)
    delta = kernels.flash_bwd_delta(o, do)
    calls = {
        "flash_bwd_delta": (lambda: kernels.flash_bwd_delta(o, do),
                            lambda: kernels.flash_bwd_delta_reference(
                                o, do)),
        "flash_bwd_dkv": (lambda: kernels.flash_bwd_dkv(
            q, k, v, do, lse, delta, causal),
            lambda: kernels.flash_bwd_dkv_reference(
                q, k, v, do, lse, delta, causal)),
        "flash_bwd_dq": (lambda: kernels.flash_bwd_dq(
            q, k, v, do, lse, delta, causal),
            lambda: kernels.flash_bwd_dq_reference(
                q, k, v, do, lse, delta, causal)),
    }
    case_rows = {}
    for name in BWD_KERNELS:
        err, ok = results[name]
        kernel_fn, plain_fn = calls[name]
        bound_ms, bound_by, fma_bound_ms = bwd_bound_ms(
            name, b, s, h, d, dname, causal)
        kernel_ms = graph_ms(kernel_fn)
        half = 0.5 if causal else 1.0
        flops = {"flash_bwd_delta": 2.0 * b * s * h * d,
                 "flash_bwd_dkv": 8.0 * b * h * s * s * d * half,
                 "flash_bwd_dq": 6.0 * b * h * s * s * d * half}[name]
        row = {"phase": phase, "name": name, "shape": [b, s, h, d],
               "dtype": dname, "causal": causal, "view": view,
               "max_abs_err": err, "max_rel_err": rel[name], "ok": ok,
               "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
               "call_ms": cuda_ms(kernel_fn),
               "plain_ms": graph_ms(plain_fn, iters=3, replays=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "fma_bound_ms": fma_bound_ms,
               "sdpa_backward_ms": library_ms}
        if view:
            row["grad_fn_max_abs_err"] = grad_err
            row["grad_fn_ok"] = grad_ok
        if name == "flash_bwd_delta":
            # one PyTorch call computes delta: rowsum(dO * O) ([B, S,
            # H] where the kernel writes [B*H, S]), f32 in f32; on the
            # bf16 views vecdot returns bf16, rounded, where delta is
            # f32 (`vecdot_dtype`)
            row["vecdot_ms"] = graph_ms(
                lambda: torch.linalg.vecdot(do, o, dim=-1))
            row["vecdot_dtype"] = str(torch.linalg.vecdot(
                do[:1], o[:1], dim=-1).dtype).replace("torch.", "")
        emit(row)
        check(ok, f"{name} disagrees with its plain version: {row}")
        if view:
            check(grad_ok, f"FlashAttentionFunction grads disagree with "
                           f"autograd of the plain forward: {row}")
        case_rows[name] = row
    del qkv, q, k, v, do, o, lse, delta, calls
    torch.cuda.empty_cache()
    return case_rows


def phase_bwd_kernels(torch, kernels):
    """The three backward kernels against their plain versions on the card,
    at the train path's shape and layout (bf16, causal, q/k/v views of one
    fused qkv projection, B=32 S=512 H=16 D=128), in f32 at [8, 512, 16,
    128] causal and not (contiguous) and causal on qkv views, in f32 at a
    ragged S with D = 100, and in bf16 at a ragged S; timed at every case.
    Each f32 case also emits the sum of its three kernels' times beside
    SDPA's whole backward (`f32_backward_sum`). Returns {kernel: row} of the
    train-path case, and under "f32_causal", "f32_not_causal",
    "f32_causal_view" and "f32_ragged" {kernel: row} of the f32 cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(32, 512, 16, 128, torch.bfloat16, True, True),
             (8, 512, 16, 128, torch.float32, True, False),
             (8, 512, 16, 128, torch.float32, False, False),
             (8, 512, 16, 128, torch.float32, True, True),
             # ragged S at a head dim zero-filled to 128 in f32
             (8, 200, 16, 100, torch.float32, True, False),
             (8, 200, 16, 64, torch.bfloat16, True, False),
             # a head dim that takes the padding route (D 100 -> 128)
             (8, 200, 16, 100, torch.bfloat16, True, False)]
    main_rows = {}
    for case in cases:
        _, s, _, _, dt, causal, view = case
        case_rows = bwd_case_rows(torch, kernels, gen, case)
        if dt == torch.bfloat16 and view:
            main_rows.update(case_rows)
        elif dt == torch.float32:
            key = ("f32_ragged" if s != 512 else
                   "f32_causal" if causal else "f32_not_causal")
            main_rows[key + ("_view" if view else "")] = case_rows
            emit(f32_backward_sum(case_rows))
    return main_rows


def f32_backward_sum(case_rows):
    """The f32 backward of one case as the train step runs it (delta, dK/dV
    and dQ, graph-replay times summed) beside SDPA's whole backward."""
    r = case_rows["flash_bwd_dq"]
    return {"phase": "f32_backward", "shape": r["shape"],
            "causal": r["causal"], "view": r["view"],
            "kernels_ms": {name: case_rows[name]["kernel_ms"]
                           for name in BWD_KERNELS},
            "sum_ms": sum(case_rows[name]["kernel_ms"]
                          for name in BWD_KERNELS),
            "sdpa_backward_ms": r["sdpa_backward_ms"]}


def ptxas_info(log: str, kernel: str) -> dict:
    """Registers and spill bytes of each compiled instance of `kernel` in an
    nvcc -Xptxas -v log: {template args: {"registers", "spill_stores",
    "spill_loads"}} (`ILi128EE...` -> "128", `ILi128ELi64EE...` ->
    "128,64": a head dim, then a tile variant's key tile)."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else ""
            cur = None
            if kernel in name:
                rest = name.split(kernel, 1)[1]
                cur = (",".join(re.findall(r"Li(\d+)E",
                                           rest.split("EE")[0] + "E"))
                       if rest.startswith("ILi") else rest)
                out[cur] = {}
        elif cur is not None and "spill stores" in line:
            words = line.replace(",", " ").split()
            out[cur]["spill_stores"] = int(words[words.index("spill") - 2])
            out[cur]["spill_loads"] = int(words[words.index("loads") - 3])
        elif cur is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out[cur]["registers"] = int(words[words.index("registers") - 1])
    return out


#: the bf16 bodies on TMA, wgmma and warp specialisation
TMA_BODIES = {"flash_attn_fwd": ("flash_attn_fwd", "flash_fwd_tma_kernel"),
              "flash_bwd_dkv": ("flash_attn_bwd", "flash_bwd_dkv_tma_kernel"),
              "flash_bwd_dq": ("flash_attn_bwd", "flash_bwd_dq_tma_kernel")}


def tma_ptxas(kernels) -> dict:
    """{kernel: ptxas_info of its TMA body} from the last build's logs."""
    return {name: ptxas_info(kernels.BUILD_LOGS.get(lib, ""), body)
            for name, (lib, body) in TMA_BODIES.items()}


#: the f32 bodies on 3xTF32 mma.sync, one instance per head-dim bucket
F32_BODIES = {"flash_attn_fwd": ("flash_attn_fwd", "flash_fwd_3xtf32_kernel"),
              "flash_bwd_dkv": ("flash_attn_bwd",
                                "flash_bwd_dkv_3xtf32_kernel"),
              "flash_bwd_dq": ("flash_attn_bwd", "flash_bwd_dq_3xtf32_kernel")}


def f32_ptxas(kernels) -> dict:
    """{kernel: ptxas_info of its f32 body} from the last build's logs."""
    return {name: ptxas_info(kernels.BUILD_LOGS.get(lib, ""), body)
            for name, (lib, body) in F32_BODIES.items()}


def check_no_spills(bodies, dims=("64", "128"), what="TMA") -> None:
    """Every body is compiled for each head dim of `dims` (each of its tile
    variants there, keyed "D,BN"), without spills."""
    for name, info in bodies.items():
        for d in dims:
            ats = [v for k, v in info.items() if k.split(",")[0] == d]
            check(bool(ats) and all(at.get("spill_stores") == 0
                                    and at.get("spill_loads") == 0
                                    for at in ats),
                  f"{name}'s {what} body spills (or is missing) at D = {d}: "
                  f"{info}")


def check_bodies(bodies, f32_bodies) -> None:
    check_no_spills(bodies)
    check_no_spills(f32_bodies, ("32", "64", "128"), "f32")


#: the fused LSTM cell's cases: (name, B, I, H, dtype name, W as views)
LSTM_CASES = [("bench", 256, 256, 256, "float32", False),
              ("bench_views", 256, 256, 256, "float32", True),
              ("cli", 2047, 27, 128, "float32", False),
              ("ragged", 3, 7, 20, "float32", False),
              ("bench_bf16", 256, 256, 256, "bfloat16", False),
              ("cli_bf16", 2047, 27, 128, "bfloat16", False),
              ("ragged_bf16", 3, 7, 20, "bfloat16", False)]


def lstm_check(torch, kernels, args):
    """The cell kernel against its plain version on `args`: (max_abs_err
    over h' and c', ok): f32 atol = rtol = 1e-5, bf16 2e-2 * max."""
    got = kernels.lstm_cell(*args)
    want = kernels.lstm_cell_reference(*args)
    torch.cuda.synchronize()
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    if args[0].dtype == torch.float32:
        ok = all(bool(torch.allclose(g, w, atol=1e-5, rtol=1e-5))
                 for g, w in zip(got, want))
    else:
        ok = all(e <= 2e-2 * w.float().abs().max().item()
                 for e, w in zip(errs, want))
    return max(errs), ok, want


#: the f32 forward's first checks: (B, S, H, D, causal, qkv views); every
#: head-dim bucket, D = 100 (zero-filled to 128) and D = 30 (single-float
#: copies), ragged S, the f32 train shape and the CLI char_transformer's
F32_QUICK_CASES = [(8, 512, 16, 128, True, True),
                   (8, 512, 16, 128, False, False),
                   (32, 256, 4, 32, True, True),
                   (2, 200, 4, 64, False, True),
                   (2, 96, 4, 100, True, True),
                   (2, 200, 4, 100, False, False),
                   (2, 200, 4, 30, True, True),
                   (2, 96, 4, 128, False, True)]


#: the f32 backward's first checks: (B, S, H, D, causal, qkv views); the
#: bench shape contiguous and on views, every head-dim bucket, D = 100
#: (zero-filled to 128) and D = 30 (single-float copies), ragged S
F32_BWD_QUICK_CASES = [(8, 512, 16, 128, True, True),
                       (8, 512, 16, 128, False, False),
                       (8, 200, 16, 100, True, False),
                       (2, 200, 4, 30, True, True),
                       (2, 96, 4, 32, False, True),
                       (2, 200, 4, 64, True, True),
                       (2, 96, 4, 64, False, False),
                       (2, 96, 4, 100, False, True),
                       (2, 200, 4, 128, False, True)]


def fwd_inputs(torch, gen, b, s, h, d, dt, view):
    """q, k, v [B, S, H, D] on the card: strided views of one fused
    [B, S, 3 * H * D] projection (as the attention layer passes them) when
    `view`, else contiguous."""
    if view:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dt)
        return qkv_views(qkv, h, d)
    return tuple(torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
                 for _ in range(3))


def f32_fwd_check(torch, kernels, q, k, v, causal, with_lse):
    """The f32 forward against its plain version: (max_abs_err of o, of lse
    or None, ok) at atol = rtol = 1e-4 on both."""
    got = kernels.flash_attention(q, k, v, causal, with_lse=with_lse)
    want = kernels.flash_attention_reference(q, k, v, causal,
                                             with_lse=with_lse)
    torch.cuda.synchronize()
    if not with_lse:
        got, want = (got, None), (want, None)
    err_o = (got[0] - want[0]).abs().max().item()
    ok = bool(torch.allclose(got[0], want[0], atol=1e-4, rtol=1e-4))
    err_lse = None
    if with_lse:
        err_lse = (got[1] - want[1]).abs().max().item()
        ok = ok and bool(torch.allclose(got[1], want[1], atol=1e-4,
                                        rtol=1e-4))
    return err_o, err_lse, ok


#: the reference's own f32 attention shapes and tolerances (atol = rtol):
#: the JAX package holds its fused f32 gradients to full attention at 1e-5
#: at (2, 64, 2, 8) and (1, 128, 2, 16) (tests/test_mfu_paths.py:276-279,
#: 303) and its f32 forward at 2e-5 (tests/test_pallas_kernels.py:25)
F32_REFERENCE_SHAPES = [(2, 64, 2, 8), (1, 128, 2, 16)]
F32_REFERENCE_TOL = {"o": 2e-5, "lse": 2e-5, "delta": 1e-5, "dk": 1e-5,
                     "dv": 1e-5, "dq": 1e-5}


def f32_reference_check(torch, kernels):
    """The f32 forward (o, lse), delta, dK/dV and dQ kernels against their
    plain versions at the reference's shapes, causal and not, each at the
    reference's tolerance (F32_REFERENCE_TOL); one `f32_reference_shapes`
    line a case with every output's max |got - want| and whether it meets
    its tolerance. Returns the rows."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for b, s, h, d in F32_REFERENCE_SHAPES:
        for causal in (False, True):
            q, k, v, do = (torch.randn(b, s, h, d, generator=gen,
                                       device="cuda") for _ in range(4))
            o, lse = kernels.flash_attention(q, k, v, causal, with_lse=True)
            pairs = dict(zip(("o", "lse"), zip(
                (o, lse), kernels.flash_attention_reference(
                    q, k, v, causal, with_lse=True))))
            delta = kernels.flash_bwd_delta_reference(o, do)
            pairs["delta"] = (kernels.flash_bwd_delta(o, do), delta)
            args = (q, k, v, do, lse, delta, causal)
            pairs.update(zip(("dk", "dv"), zip(
                kernels.flash_bwd_dkv(*args),
                kernels.flash_bwd_dkv_reference(*args))))
            pairs["dq"] = (kernels.flash_bwd_dq(*args),
                           kernels.flash_bwd_dq_reference(*args))
            torch.cuda.synchronize()
            row = {"phase": "f32_reference_shapes", "shape": [b, s, h, d],
                   "causal": causal}
            for name, (got, want) in pairs.items():
                tol = F32_REFERENCE_TOL[name]
                row[name] = {
                    "max_abs_err": (got - want).abs().max().item(),
                    "tol": tol,
                    "ok": bool(torch.allclose(got, want, atol=tol,
                                              rtol=tol))}
            row["ok"] = all(row[name]["ok"] for name in pairs)
            emit(row)
            rows.append(row)
    return rows


def phase_f32_reference(torch, kernels):
    """`f32_reference_check`, held: the run fails if an output misses the
    reference's tolerance."""
    rows = f32_reference_check(torch, kernels)
    for row in rows:
        check(row["ok"], f"an f32 attention kernel misses the reference's "
                         f"tolerance at its shape: {row}")
    return rows


def phase_quick(torch, kernels):
    """The first check of new kernel bodies: the bf16 forward (o, lse) and
    the three backward kernels against their plain versions once each, at
    the serving and training shapes on qkv views, contiguous and not
    causal, at ragged S (200, and 96: less than one block) and at a head
    dim that takes the padding route; the f32 forward in F32_QUICK_CASES
    and the f32 backward kernels in F32_BWD_QUICK_CASES; then the LSTM cell
    in its seven cases, the f32 attention kernels at the reference's shapes
    and tolerances (`f32_reference_check`), the scatter-add's D = 1 body in
    `d1_ragged_cases` and its f32 D > 1 body in `sorted_body_cases`; no
    timing. Returns whether every case passed."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(8, 512, 16, 128, True, True), (32, 512, 16, 128, True, True),
             (8, 512, 16, 128, False, False), (8, 200, 16, 64, True, False),
             (2, 200, 4, 100, True, False), (2, 96, 4, 64, False, True),
             (2, 96, 4, 128, True, True), (2, 200, 4, 128, False, True),
             (2, 96, 4, 100, False, True)]
    all_ok = True
    for b, s, h, d, causal, view in cases:
        copies = kernels.PAD_COPIES
        qkv, q, k, v, do, o, lse = bwd_inputs(torch, kernels, gen, b, s, h,
                                              d, torch.bfloat16, causal,
                                              view)
        want_o, want_lse = kernels.flash_attention_reference(
            q, k, v, causal, with_lse=True)
        torch.cuda.synchronize()
        err_o = (o.float() - want_o.float()).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        ok_fwd = err_o <= 2e-2 * want_o.float().abs().max().item() and \
            err_lse <= 1e-3
        results = bwd_check(torch, kernels, q, k, v, do, o, lse, causal)
        row = {"phase": "quick", "shape": [b, s, h, d], "causal": causal,
               "view": view, "fwd_max_abs_err": err_o,
               "fwd_max_abs_err_lse": err_lse, "fwd_ok": ok_fwd,
               "pad_copies": kernels.PAD_COPIES - copies}
        for name, (err, ok) in results.items():
            row[name] = {"max_abs_err": err, "ok": ok}
        emit(row)
        all_ok = all_ok and ok_fwd and all(ok for _, ok in results.values())
        del qkv, q, k, v, do, o, lse
    for b, s, h, d, causal, view in F32_QUICK_CASES:
        q, k, v = fwd_inputs(torch, gen, b, s, h, d, torch.float32, view)
        err_o, err_lse, ok = f32_fwd_check(torch, kernels, q, k, v, causal,
                                           True)
        emit({"phase": "quick", "name": "flash_attn_fwd", "dtype": "float32",
              "shape": [b, s, h, d], "causal": causal, "view": view,
              "max_abs_err": err_o, "max_abs_err_lse": err_lse, "ok": ok})
        all_ok = all_ok and ok
        del q, k, v
    for b, s, h, d, causal, view in F32_BWD_QUICK_CASES:
        qkv, q, k, v, do, o, lse = bwd_inputs(torch, kernels, gen, b, s, h,
                                              d, torch.float32, causal,
                                              view)
        results = bwd_check(torch, kernels, q, k, v, do, o, lse, causal)
        row = {"phase": "quick", "dtype": "float32", "shape": [b, s, h, d],
               "causal": causal, "view": view}
        for name, (err, ok) in results.items():
            row[name] = {"max_abs_err": err, "ok": ok}
        emit(row)
        all_ok = all_ok and all(ok for _, ok in results.values())
        del qkv, q, k, v, do, o, lse
    for name, b, i, h, dname, view in LSTM_CASES:
        args = lstm_cell_inputs(torch, gen, b, i, h, getattr(torch, dname),
                                view)
        err, ok, _ = lstm_check(torch, kernels, args)
        emit({"phase": "quick", "name": "lstm_cell", "case": name,
              "shape_bih": [b, i, h], "dtype": dname, "max_abs_err": err,
              "ok": ok})
        all_ok = all_ok and ok
    for name, r, width, idx, dt in d1_ragged_cases(torch):
        exact, err, close, *_ = scatter_check(torch, kernels, gen, r, width,
                                              idx, dt)
        emit({"phase": "quick", "name": "scatter_add_rows", "case": name,
              "exact_on_integers": exact, "max_abs_err": err,
              "within_sum_bound": close, "ok": exact and close})
        all_ok = all_ok and exact and close
    for name, r, width, idx in sorted_body_cases(torch):
        exact, err, close, _ = scatter_check(torch, kernels, gen, r, width,
                                             idx, torch.float32)
        emit({"phase": "quick", "name": "scatter_add_rows", "case": name,
              "width": width, "n": int(idx.shape[0]),
              "exact_on_integers": exact, "max_abs_err": err,
              "within_sum_bound": close, "ok": exact and close})
        all_ok = all_ok and exact and close
    return all_ok and all(r["ok"] for r in f32_reference_check(torch,
                                                               kernels))


def phase_kernels(torch, kernels):
    """Kernel vs plain version on the card; returns {case: row} of the two
    bf16 cases the main paths run, both causal on q, k, v strided views of
    one fused [B, S, 3 * H * D] projection: "serve" (B=8, no lse) and
    "train" (the train step's forward, B=32, with lse); of the f32 forward
    with lse at [8, 512, 16, 128], "f32_causal" and "f32_not_causal"
    (contiguous), "f32_causal_view" (qkv views); and "f32_cli": the CLI's
    default char_transformer (d_model 128, 4 heads: D = 32) at
    [32, 256, 4, 32], causal on views, without lse, as its forward runs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for with_lse in (False, True):
                cases.append((8, 512, 16, 128, dt, causal, with_lse, False))
    cases += [(8, 512, 16, 128, torch.bfloat16, True, False, True),
              (32, 512, 16, 128, torch.bfloat16, True, True, True),
              (8, 200, 16, 64, torch.bfloat16, True, True, False),
              (8, 200, 16, 64, torch.float32, False, True, False),
              # a head dim that takes the padding route (D 100 -> 128)
              (8, 200, 16, 100, torch.bfloat16, True, True, False),
              (8, 200, 16, 100, torch.float32, True, True, False),
              (8, 512, 16, 128, torch.float32, True, True, True),
              (32, 256, 4, 32, torch.float32, True, False, True)]
    path_rows = {}
    for case in cases:
        b, s, h, d, dt, causal, with_lse, view = case
        row = fwd_kernel_row(torch, kernels, gen, case)
        if dt == torch.bfloat16 and view:
            path_rows["train" if with_lse else "serve"] = row
        elif dt == torch.float32 and d == 32:
            path_rows["f32_cli"] = row
        elif dt == torch.float32 and s == 512 and with_lse:
            # what an f32 conf's train step runs (the forward with lse)
            key = "f32_causal" if causal else "f32_not_causal"
            path_rows[key + ("_view" if view else "")] = row
        torch.cuda.empty_cache()
    return path_rows


def fwd_kernel_row(torch, kernels, gen, case, phase="kernel"):
    """One forward case (b, s, h, d, dtype, causal, with_lse, view): the
    kernel against its plain version (f32: 1e-4 on o and lse; bf16: 2e-2 on
    o, 1e-3 on lse), timed beside its plain version and SDPA by graph
    replay, its eager call and its bound. Emits and returns the row; a
    disagreement fails the run."""
    import torch.nn.functional as F

    b, s, h, d, dt, causal, with_lse, view = case
    q, k, v = fwd_inputs(torch, gen, b, s, h, d, dt, view)
    if dt == torch.float32:
        err_o, err_lse, ok = f32_fwd_check(torch, kernels, q, k, v, causal,
                                           with_lse)
    else:
        got = kernels.flash_attention(q, k, v, causal, with_lse=with_lse)
        want = kernels.flash_attention_reference(q, k, v, causal,
                                                 with_lse=with_lse)
        torch.cuda.synchronize()
        if not with_lse:
            got, want = (got, None), (want, None)
        err_o = (got[0].float() - want[0].float()).abs().max().item()
        ok = torch.allclose(got[0].float(), want[0].float(), atol=2e-2)
        err_lse = None
        if with_lse:
            err_lse = (got[1] - want[1]).abs().max().item()
            ok = ok and torch.allclose(got[1], want[1], atol=1e-3,
                                       rtol=1e-3)
        del got, want
    dname = str(dt).replace("torch.", "")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel_ms = graph_ms(lambda: kernels.flash_attention(
        q, k, v, causal, with_lse=with_lse))
    call_ms = cuda_ms(lambda: kernels.flash_attention(
        q, k, v, causal, with_lse=with_lse))
    plain_ms = graph_ms(lambda: kernels.flash_attention_reference(
        q, k, v, causal, with_lse=with_lse), iters=5, replays=1)
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    bound_ms, bound_by, fma_bound_ms = attention_bound_ms(
        b, s, h, d, dname, causal, with_lse)
    flops = 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)
    row = {"phase": phase, "name": "flash_attn_fwd",
           "shape": [b, s, h, d], "dtype": dname, "causal": causal,
           "with_lse": with_lse, "view": view, "max_abs_err": err_o,
           "max_abs_err_lse": err_lse, "ok": bool(ok),
           "kernel_ms": kernel_ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "fma_bound_ms": fma_bound_ms,
           "tflops": flops / kernel_ms / 1e9}
    emit(row)
    check(ok, f"flash_attn_fwd disagrees with its plain version: {row}")
    return row


def post(url, body, timeout=300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def phase_serve(torch, kernels):
    """The full-width charTransformer served to concurrent requests."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_output)

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=SLICE["n_blocks"],
                            n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"])
    conf = conf.with_compute_dtype("bfloat16")
    conf = conf.replace(confs=tuple(c.replace(attention_impl="flash")
                                    for c in conf.confs))
    t0 = time.perf_counter()
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for layer in net.params for t in layer.values())
    rng = np.random.RandomState(0)
    xs = [rng.randint(0, SLICE["vocab"], (REQUEST_ROWS, SLICE["seq"]))
          for _ in range(REQUESTS)]
    # first-call set-up (cuBLAS handles, the captures of the request's and
    # the coalesced batch's buckets) outside the run
    net.warmup([xs[0], np.concatenate(xs)])
    torch.cuda.synchronize()

    kernels.reset_launches()
    kernels.PAD_COPIES = 0
    server = net.serve(port=0, max_delay_ms=200.0,
                       max_batch_rows=REQUESTS * REQUEST_ROWS)
    answers = [None] * REQUESTS
    latencies = [None] * REQUESTS
    errors = []

    def client(i):
        t = time.perf_counter()
        try:
            answers[i] = np.asarray(post(server.url + "/v1/predict",
                                         {"features": xs[i].tolist(),
                                          "dtype": "int32"})["output"],
                                    np.float32)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        latencies[i] = (time.perf_counter() - t) * 1e3

    t_all = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_all
    stats = server.stats()
    serve_launches = dict(kernels.LAUNCHES)
    serve_pad_copies = kernels.PAD_COPIES
    # an id outside the vocabulary is refused on the host with a 400; on
    # the card it would be a device-side assert that ends the process's
    # CUDA context (the direct checks below then show the card still works)
    bad = xs[0].copy()
    bad[0, 0] = 300
    try:
        post(server.url + "/v1/predict", {"features": bad.tolist(),
                                          "dtype": "int32"})
        bad_status = 200
    except urllib.error.HTTPError as e:
        bad_status = e.code
    # the breaker gauge of /metrics against `CircuitBreaker.state_code`
    breaker = {"state": server.batcher.breaker.state,
               "state_code": server.batcher.breaker.state_code,
               "metrics_gauge": metrics_gauge(
                   server.url, "dl4j_serving_breaker_state")}
    server.drain()
    check(not errors, f"requests failed: {errors}")
    check(bad_status == 400, f"an out-of-vocabulary id got {bad_status}")
    flushes = sum(stats["batch_rows_hist"].values())
    n_attn = SLICE["n_blocks"]
    check(serve_launches["flash_attn_fwd"] == n_attn * flushes,
          f"flash launches {serve_launches} != {n_attn} x {flushes} flushes")
    check(serve_pad_copies == 0,
          f"the serve path made {serve_pad_copies} padding copies")
    check(stats["degraded_batches"] == 0,
          f"the served batches took the degraded path: {stats}")

    errs_direct = []
    kernels.reset_launches()
    for x, ans in zip(xs, answers):
        check(ans.shape == (REQUEST_ROWS * SLICE["seq"], SLICE["vocab"]),
              f"answer shape {ans.shape}")
        check(bool(np.isfinite(ans).all()), "answer has non-finite values")
        row_err = float(np.abs(ans.sum(axis=1) - 1.0).max())
        check(row_err < 1e-3, f"rows do not sum to 1: {row_err}")
        direct = net.output(x).float().cpu().numpy()
        errs_direct.append(float(np.abs(ans - direct).max()))
    direct_launches = kernels.LAUNCHES["flash_attn_fwd"]
    check(direct_launches == n_attn * REQUESTS,
          f"direct checks launched flash {direct_launches} times, want "
          f"{n_attn * REQUESTS}")
    check(max(errs_direct) < 2e-2,
          f"served answer differs from net.output: {errs_direct}")
    check(breaker["metrics_gauge"] == breaker["state_code"] == 0,
          f"the breaker gauge of /metrics is not its state_code: {breaker}")
    surface = serve_surface(torch, kernels, net, xs)

    # the flash path against the plain attention path on the same weights,
    # in f32 compute, where the two differ only by f32 rounding (in bf16
    # the plain path's bf16 softmax is the larger error)
    f32_conf = conf.with_compute_dtype("")
    plain_conf = f32_conf.replace(confs=tuple(
        c.replace(attention_impl="full") for c in f32_conf.confs))
    with torch.inference_mode():
        x0 = torch.as_tensor(xs[0], device="cuda")
        flash32 = network_output(f32_conf, net.params, x0)
        plain32 = network_output(plain_conf, net.params, x0)
    err_plain = (flash32 - plain32).abs().max().item()
    check(err_plain < 1e-4,
          f"f32 flash path differs from the plain attention path: "
          f"{err_plain}")
    # the f32 network output at these widths (8 f32 flash forwards of
    # [2, 512, 16, 128] among the f32 GEMMs), and the same on the plain
    # attention path: eager calls, CUDA events, median of 5
    with torch.inference_mode():
        f32_ms = {name: [event_ms(torch, lambda c=c: network_output(
            c, net.params, x0)) for _ in range(5)]
            for name, c in (("flash", f32_conf), ("plain", plain_conf))}
    # where a request's time goes: one eager forward over the coalesced
    # batch (CUDA events; host launch work included), and the host's JSON
    # work on one answer
    xb = np.concatenate(xs)
    books = graph_books(net)
    # the coalesced batch's forward through the infer cache (a replay) and
    # eagerly (the cache off), in turns
    forward = {"captured": [], "eager": []}
    for cached in (True, False, False, True):
        net.use_infer_cache = cached
        forward["captured" if cached else "eager"].append(
            cuda_ms(lambda: net.output(xb), iters=5, warmup=1))
    net.use_infer_cache = True
    forward_ms = min(forward["captured"])
    t = time.perf_counter()
    body = json.dumps({"output": answers[0].tolist()})
    encode_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    json.loads(body)
    decode_ms = (time.perf_counter() - t) * 1e3
    rows = REQUESTS * REQUEST_ROWS
    emit({"phase": "serve", "config": SLICE, "compute_dtype": "bfloat16",
          "params": n_params, "init_s": init_s,
          "requests": REQUESTS, "rows_per_request": REQUEST_ROWS,
          "latency_ms": latencies, "wall_s": wall_s,
          "server_latency_ms": stats["latency_ms"],
          "forward_ms": forward_ms, "forward_ms_turns": forward,
          "graph": books,
          "answer_json_encode_ms": encode_ms,
          "answer_json_decode_ms": decode_ms,
          "answer_json_bytes": len(body),
          "rows_per_s": rows / wall_s,
          "tokens_per_s": rows * SLICE["seq"] / wall_s,
          "batch_rows_hist": stats["batch_rows_hist"],
          "flash_launches_serve": serve_launches["flash_attn_fwd"],
          "pad_copies_serve": serve_pad_copies,
          "out_of_vocab_status": bad_status,
          "flash_launches_direct": direct_launches,
          "max_abs_err_vs_direct": max(errs_direct),
          "max_abs_err_f32_flash_vs_plain_attention": err_plain,
          "f32_forward_ms": sorted(f32_ms["flash"])[2],
          "f32_forward_ms_all": f32_ms["flash"],
          "f32_forward_plain_attention_ms": sorted(f32_ms["plain"])[2],
          "breaker": breaker, "surface": surface,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return serve_launches, surface["flash_launches"]


def metrics_gauge(url: str, name: str) -> float:
    """The value of the unlabelled-or-labelled gauge `name` in the
    Prometheus text of GET /metrics."""
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    raise SmokeFailure(f"/metrics has no {name}")


def eval_counts(ev) -> list:
    """An `Evaluation`'s confusion counts: (actual, predicted, count)."""
    classes = sorted(ev.confusion.classes)
    return [(a, p, ev.confusion.count(a, p)) for a in classes
            for p in classes if ev.confusion.count(a, p)]


def program_rows(cache) -> list:
    """A cache's `program_memory()` as JSON rows (keys as repr)."""
    return [dict(r, key=repr(r["key"]), entry=str(r["entry"]))
            for r in cache.program_memory()]


def check_program_rows(rows, what: str) -> None:
    """One card, no model axis: each program's per-device argument bytes
    are its replicated bytes, and each captured graph states its pool."""
    check(bool(rows), f"{what}: program_memory() has no rows")
    for r in rows:
        check(0 < r["per_device_argument_bytes"]
              == r["replicated_argument_bytes"]
              and r["memory_analysis"] is not None
              and r["memory_analysis"]["graph_pool_bytes"] >= 0,
              f"{what}: program_memory row {r}")


def serve_surface(torch, kernels, net, xs) -> dict:
    """Slice 27's calls on the served flagship (bf16, SLICE's widths):
    `f1_score` on two requests' rows against `evaluate` of the same rows;
    two batches evaluated into one `Evaluation` (`evaluate(...,
    evaluation=)`) against one `evaluate` over both, cut into the same two
    batches (the same forwards, so the counts must be equal); and the infer
    cache's `program_memory()`. Labels: one-hot ids from RandomState(5).
    Counts its flash launches, 8 a forward."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.evaluation import Evaluation, evaluate

    t0 = time.perf_counter()
    vocab, rows = SLICE["vocab"], REQUEST_ROWS * SLICE["seq"]
    rng = np.random.RandomState(5)
    ys = [np.eye(vocab, dtype=np.float32)[rng.randint(0, vocab, rows)]
          for _ in range(2)]
    kernels.reset_launches()
    f1 = net.f1_score(xs[0], ys[0])
    single = evaluate(net, DataSet(xs[0], ys[0]))
    into = Evaluation()
    for x, y in zip(xs[:2], ys):
        check(evaluate(net, DataSet(x, y), evaluation=into) is into,
              "evaluate(evaluation=) returned another Evaluation")
    both = evaluate(net, DataSet(np.concatenate(xs[:2]), np.concatenate(ys)),
                    batch_size=REQUEST_ROWS)
    launches = kernels.LAUNCHES["flash_attn_fwd"]
    seconds = time.perf_counter() - t0
    memory = program_rows(net.infer_cache)
    row = {"rows_per_batch": REQUEST_ROWS, "label_rows": rows,
           "f1_score": f1, "evaluate_f1": single.f1(),
           "into_two_batches": {"total": into.confusion.total(),
                                "accuracy": into.accuracy(),
                                "f1": into.f1()},
           "one_evaluate_over_both": {"total": both.confusion.total(),
                                      "accuracy": both.accuracy(),
                                      "f1": both.f1()},
           "counts_equal": eval_counts(into) == eval_counts(both),
           "flash_launches": launches, "seconds": seconds,
           "infer_program_memory": memory}
    check(f1 == single.f1(), f"f1_score {f1} is not evaluate's "
          f"{single.f1()}")
    check(row["counts_equal"] and into.confusion.total() == 2 * rows,
          f"evaluate(evaluation=) over two batches differs from one "
          f"evaluate over both: {row}")
    check(launches == 6 * SLICE["n_blocks"],
          f"f1_score and the evaluates launched flash {launches} times, "
          f"want {6 * SLICE['n_blocks']} (6 forwards)")
    check_program_rows(memory, "serve infer cache")
    return row


# ---------------------------------------------------------------- generate

#: the generate phase: the served charTransformer (SLICE, bf16) through a
#: 4-slot `ContinuousBatcher` of 512-token tables with prompt buckets 64 and
#: 256, 8 POST /v1/generate requests from 4 concurrent clients, prompts of
#: 40-250 seeded ids, 128 new tokens each, half greedy, half at 0.8
GEN = dict(n_blocks=SLICE["n_blocks"], slots=4, max_seq=512,
           buckets=(64, 256), requests=4, clients=4, prompt_min=40,
           prompt_max=250, max_new=128, temperature=0.8)
#: --quick: the same widths at 2 blocks, 2 requests of 16 tokens
GEN_QUICK = dict(GEN, n_blocks=2, requests=2, clients=2, max_new=16)
#: the option passes after the K = 1 pass, on the same net and requests:
#: K steps a dispatch (ladder 1/2/4/8), the paged pool of 16-token pages
#: (the default pool, then `overcommit` pages: 4 streams of up to 24 pages
#: must queue and be preempted) and the prefix cache (longest match: the
#: requests, `repeats` of them again, then `extend` of them with `suffix`
#: more prompt tokens)
GEN_OPTIONS = dict(k=8, page_size=16, overcommit=48, repeats=2, extend=2,
                   suffix=16)
GEN_OPTIONS_QUICK = dict(GEN_OPTIONS, overcommit=32, repeats=2, extend=2)
#: the prompt buckets at which the forward kernel is held to its plain
#: version (the warmed buckets, the JAX package's smallest, and ragged
#: lengths inside them); timed at the warmed ones
PREFILL_CHECK_S = (4, 8, 40, 64, 250, 256)
#: CharLSTM.generate at BASELINE config 1's widths (one-hot input, as
#: CharLSTM builds it): 50 characters, 4 layers of 256
GEN_LSTM = dict(vocab=50, hidden=256, n_layers=4, seed_chars=20, n=200)
#: speculative decoding on the generate pass's net and requests: a char-LSTM
#: draft at the bench's LSTM widths (embed and hidden 256, 4 layers) with the
#: target's vocabulary, chunks of k = 4, dense then over the default pool of
#: 16-token pages; the f32 greedy variant at 2 blocks serves `f32_requests`
#: of the requests, `f32_new` tokens each
GEN_SPEC = dict(k=4, draft_seed=11, page_size=16, f32_requests=2,
                f32_new=64)
#: the char-LSTM target of speculative decoding (lstm_conf's widths in f32):
#: `requests` prompts of 10-30 ids, `new` tokens each, greedy and at 0.8,
#: with a cloned draft and a disagreeing `char_lstm(50, hidden=8)`
SPEC_LSTM = dict(requests=2, new=64, max_seq=128, buckets=(32,), k=4,
                 slots=4, temperature=0.8)


def gen_conf(n_blocks, compute_dtype="bfloat16"):
    """The charTransformer at SLICE's widths and `n_blocks` blocks, on the
    default attention impl ("auto": the flash kernel on the card)."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=n_blocks, n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"])
    return conf.with_compute_dtype(compute_dtype) if compute_dtype else conf


def post_generate(url, body, timeout=300.0):
    """POST /v1/generate: (status, the JSON lines of the streamed body)."""
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, [json.loads(x) for x in
                             resp.read().decode().splitlines() if x.strip()]


def get_json(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def prefill_kernel_checks(torch, kernels):
    """(c): the forward kernel at B = 1, S = each of PREFILL_CHECK_S, causal
    on qkv views (as every prefill calls it), against its plain version:
    bf16 within 2e-2 of max|o|, f32 at 1e-4. Returns the rows."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    h, d = SLICE["n_heads"], SLICE["d_model"] // SLICE["n_heads"]
    for s in PREFILL_CHECK_S:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = fwd_inputs(torch, gen, 1, s, h, d, dt, True)
            if dt == torch.float32:
                err, _, ok = f32_fwd_check(torch, kernels, q, k, v, True,
                                           False)
                tol = 1e-4
            else:
                got = kernels.flash_attention(q, k, v, True)
                want = kernels.flash_attention_reference(q, k, v, True)
                err = (got.float() - want.float()).abs().max().item()
                tol = 2e-2 * want.float().abs().max().item()
                ok = err <= tol
            row = {"shape": [1, s, h, d],
                   "dtype": str(dt).replace("torch.", ""),
                   "max_abs_err": err, "tol": tol, "ok": bool(ok)}
            rows.append(row)
            check(ok, f"flash_attn_fwd at a prefill shape: {row}")
    emit({"phase": "generate_prefill_kernel", "cases": rows})
    return rows


def threefry_check(torch):
    """(d): the sampler's keys, draws and uniforms on the card equal the
    CPU's bit for bit over 1,000 keys; the categorical draws (through
    `log`, whose last place may round otherwise) are counted."""
    from deeplearning4j_tpu_torch.nd import random as nd_random

    rs = np.random.RandomState(17)
    keys = rs.randint(0, 2 ** 32, size=(1000, 2), dtype=np.uint64).astype(
        np.uint32)
    logits = rs.randn(1000, SLICE["vocab"]).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        k = nd_random.key_array(keys, dev)
        out[dev] = [nd_random.split(k).cpu(),
                    nd_random.random_bits(k, SLICE["vocab"]).cpu(),
                    nd_random.uniform(k, SLICE["vocab"], 1.2e-38, 1.0).cpu(),
                    nd_random.categorical(
                        k, torch.as_tensor(logits, device=dev)).cpu()]
    same = [torch.equal(a, b) for a, b in zip(out["cpu"][:3],
                                              out["cuda"][:3])]
    agree = int((out["cpu"][3] == out["cuda"][3]).sum())
    row = {"phase": "generate_threefry", "keys": 1000,
           "split_bitwise": same[0], "bits_bitwise": same[1],
           "uniform_bitwise": same[2], "categorical_agree": agree}
    emit(row)
    check(all(same), f"the card's threefry differs from the CPU's: {row}")
    return row


def decode_bounds(net, conf, slots, max_seq):
    """(bytes of one decode step as the step runs it, f32 params read and
    every matmul weight cast to bf16 and read again; bytes with the weights
    read once in bf16): each with the K/V tables of every attention layer
    read once."""
    from deeplearning4j_tpu_torch.nn.conf import LayerType

    n_all = sum(t.numel() for layer in net.params for t in layer.values())
    n_cast = sum(layer[k].numel() for layer in net.params
                 for k in ("Wqkv", "Wo", "W1", "W2") if k in layer)
    n_cast += net.params[-1]["W"].numel()  # the output layer
    n_attn = sum(1 for c in conf.confs
                 if LayerType(str(c.layer_type)) == LayerType.ATTENTION)
    kv = 2 * n_attn * slots * max_seq * SLICE["d_model"] * 2
    return 4 * n_all + 4 * n_cast + kv, 2 * n_cast + kv


def decode_eager_check(torch, net, prompt, steps, temperature, seed):
    """(a) on one stream: the cached path (`ic.prefill`, `ic.decode`; on the
    card graph replays) against the eager `nn/decode.py` loop with the same
    sampler on another state. Returns (tokens equal, keys equal, max state
    gap, the logp gap of one eager step from each final state, the cached
    tokens)."""
    from deeplearning4j_tpu_torch.nd import random as nd_random
    from deeplearning4j_tpu_torch.nn import decode as decode_mod
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    ic, conf = net.infer_cache, net.conf
    n = len(prompt)
    bucket = 1 << (n - 1).bit_length()
    pb = np.zeros((1, bucket), np.int32)
    pb[0, :n] = prompt
    temps = torch.full((1,), float(temperature), device="cuda")
    keys = nd_random.prng_key(seed, "cuda")[None]
    cached = ic.init_decode_state(conf, 1, GEN["max_seq"], "cuda")
    eager = ic.init_decode_state(conf, 1, GEN["max_seq"], "cuda")
    tok, ck, cached = ic.prefill(conf, net.params, cached, pb,
                                 np.asarray([n], np.int32), keys, temps)
    with torch.inference_mode():
        logp, eager = decode_mod.prefill(
            conf, net.params, eager, torch.as_tensor(pb, device="cuda"),
            torch.as_tensor([n], device="cuda"))
        etok, ek = nd_random.sample_tokens(logp.float(), keys, temps)
    toks, etoks = [int(tok[0])], [int(etok[0])]
    keys_same = torch.equal(ck, ek)
    pos = np.asarray([n], np.int32)
    for _ in range(steps - 1):
        tok, ck, cached = ic.decode(conf, net.params, cached, tok, pos, ck,
                                    temps)
        with torch.inference_mode():
            logp, eager = decode_mod.decode_step(
                conf, net.params, eager, etok,
                torch.as_tensor(pos, device="cuda"))
            etok, ek = nd_random.sample_tokens(logp.float(), ek, temps)
        toks.append(int(tok[0]))
        etoks.append(int(etok[0]))
        keys_same = keys_same and torch.equal(ck, ek)
        pos = pos + 1
    # the final states' K/V rows past the written positions are zero in
    # both; the carries of a recurrent stack are compared whole
    gap = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(tree_leaves(cached), tree_leaves(eager)))
    with torch.inference_mode():
        nxt = torch.as_tensor([toks[-1]], device="cuda")
        p_t = torch.as_tensor(pos, device="cuda")
        lc, _ = decode_mod.decode_step(conf, net.params, cached, nxt, p_t)
        le, _ = decode_mod.decode_step(conf, net.params, eager, nxt, p_t)
    logp_gap = (lc.float() - le.float()).abs().max().item()
    return toks == etoks, bool(keys_same), gap, logp_gap, toks


def teacher_forced_gap(torch, net, prompt, tokens):
    """(b): the eager decode path's logp at every position of prompt +
    tokens, teacher-forced (B = 1: the prefill, then one decode step a
    token), against the full re-forward `network_output` of the sequence:
    (max |gap|, max |logp| of the re-forward)."""
    from deeplearning4j_tpu_torch.nn import decode as decode_mod
    from deeplearning4j_tpu_torch.nn.multilayer import network_output

    conf = net.conf
    n = len(prompt)
    seq = list(prompt) + list(tokens[:-1])
    with torch.inference_mode():
        state = decode_mod.init_state(conf, 1, GEN["max_seq"], "cuda")
        logp, state = decode_mod.prefill(
            conf, net.params, state,
            torch.as_tensor([prompt], device="cuda"),
            torch.as_tensor([n], device="cuda"))
        rows = [logp[0].float()]
        for j, t in enumerate(tokens[:-1]):
            logp, state = decode_mod.decode_step(
                conf, net.params, state, torch.as_tensor([t], device="cuda"),
                torch.as_tensor([n + j], device="cuda"))
            rows.append(logp[0].float())
        probs = network_output(conf, net.params,
                               torch.as_tensor([seq], device="cuda"))
        ref = torch.log(torch.clamp(probs.float(), 1e-9, 1.0))[n - 1:]
    got = torch.stack(rows)
    return (got - ref).abs().max().item(), ref.abs().max().item()


def f32_token_identity(torch, steps=16):
    """Greedy tokens of the cached path against the re-forward's argmax over
    the growing sequence (the JAX package's test), in f32 at 2 blocks of
    SLICE's widths: (equal, the cached tokens, the re-forward's, (a) on the
    same net: tokens/keys equal, state gap, logp gap)."""
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_output)

    net = MultiLayerNetwork(gen_conf(2, ""), device="cuda", seed=1).init()
    prompt = np.random.RandomState(5).randint(0, SLICE["vocab"],
                                              100).tolist()
    same_tok, same_keys, gap, logp_gap, toks = decode_eager_check(
        torch, net, prompt, steps, 0.0, 0)
    seq, ref = list(prompt), []
    with torch.inference_mode():
        for _ in range(steps):
            probs = network_output(net.conf, net.params,
                                   torch.as_tensor([seq], device="cuda"))
            ref.append(int(torch.argmax(torch.log(torch.clamp(
                probs[-1], 1e-9, 1.0)))))
            seq.append(ref[-1])
    del net
    return toks == ref, toks, ref, (same_tok, same_keys, gap, logp_gap)


def charlstm_generate_check(torch):
    """(e): `CharLSTM.generate` (captured prefill and decode) equals
    `CharLSTM.sample` (eager steps) for GEN_LSTM["n"] characters, greedy and
    at 0.8, at BASELINE config 1's widths with random weights."""
    from deeplearning4j_tpu_torch.models.char_lstm import CharLSTM
    from deeplearning4j_tpu_torch.models.zoo import char_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    g = GEN_LSTM
    m = CharLSTM(hidden=g["hidden"], n_layers=g["n_layers"], device="cuda")
    m.chars = [chr(48 + i) for i in range(g["vocab"])]
    m.char_index = {c: i for i, c in enumerate(m.chars)}
    m.net = MultiLayerNetwork(char_lstm(g["vocab"], hidden=g["hidden"],
                                        n_layers=g["n_layers"]),
                              device="cuda", seed=0).init()
    seed_text = "".join(m.chars[i] for i in np.random.RandomState(6).randint(
        0, g["vocab"], g["seed_chars"]))
    runs = {}
    for temp, seed in ((0.0, 0), (0.8, 3)):
        t = time.perf_counter()
        got = m.generate(seed_text, n=g["n"], temperature=temp,
                         rng_seed=seed)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        want = m.sample(seed_text, n=g["n"], temperature=temp, rng_seed=seed)
        sample_s = time.perf_counter() - t
        runs[str(temp)] = {"equal": got == want, "generate_s": gen_s,
                           "sample_s": sample_s,
                           "distinct_chars": len(set(got))}
        check(got == want, f"CharLSTM.generate != sample at {temp}: "
                           f"{got[:40]!r} vs {want[:40]!r}")
    row = {"phase": "generate_char_lstm", "config": g, "runs": runs,
           "graph": graph_books(m.net)}
    emit(row)
    return row


def serve_generation(torch, kernels, net, g, groups, **options):
    """Serve groups of requests ((prompt, temperature, rng_seed) each, of
    g["max_new"] tokens) through POST /v1/generate on one server whose
    `ContinuousBatcher` has the batcher `options`, from g["clients"]
    clients, a group after the one before it has ended. The kernel counts
    are set to 0 just before the server starts and read just before it
    drains. Checks every stream. Returns the tokens by group, latencies,
    each group's TTFTs, every dispatch's (K, wall s, wait s), /v1/stats'
    generation block, the wall seconds and the launches."""
    kernels.reset_launches()
    kernels.PAD_COPIES = 0
    server = net.serve(port=0, generate=True, gen_slots=g["slots"],
                       gen_max_seq=g["max_seq"],
                       gen_prompt_buckets=g["buckets"],
                       **{SERVE_OPTION[k]: v for k, v in options.items()})
    gen = server.generator
    dispatches, rounds = [], []
    note, note_round = gen._note_block, gen._note_round

    def record(k, wall, wait, emitted, now):
        dispatches.append((k, wall, wait))
        note(k, wall, wait, emitted, now)

    def record_round(wall, wait, emitted, accepted, now):
        rounds.append((wall, wait, emitted))
        note_round(wall, wait, emitted, accepted, now)

    gen._note_block = record
    gen._note_round = record_round
    out = {"streams": [], "latency_ms": [], "ttft_ms": []}
    errors = []
    t_all = time.perf_counter()
    for reqs in groups:
        results = [None] * len(reqs)
        latency_ms = [None] * len(reqs)
        todo = list(range(len(reqs)))
        lock = threading.Lock()
        n_ttft = len(gen._ttfts)

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop(0)
                prompt, temp, seed = reqs[i]
                t = time.perf_counter()
                try:
                    results[i] = post_generate(server.url, {
                        "prompt": prompt, "max_new_tokens": g["max_new"],
                        "temperature": temp, "rng_seed": seed})
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))
                latency_ms[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client)
                   for _ in range(g["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(not errors, f"generate requests failed: {errors}")
        streams = []
        for i, (status, lines) in enumerate(results):
            toks = [x["token"] for x in lines if "token" in x]
            check(status == 200 and lines[-1].get("done") is True
                  and "error" not in lines[-1]
                  and lines[-1]["tokens"] == g["max_new"] == len(toks)
                  and all(0 <= t < SLICE["vocab"] for t in toks),
                  f"request {i}: status {status}, last line {lines[-1]}, "
                  f"{len(toks)} tokens")
            streams.append(toks)
        out["streams"].append(streams)
        out["latency_ms"].append(latency_ms)
        out["ttft_ms"].append([t * 1e3 for t in list(gen._ttfts)[n_ttft:]])
    out["wall_s"] = time.perf_counter() - t_all
    out["stats"] = get_json(server.url + "/v1/stats")["generation"]
    out["launches"] = dict(kernels.LAUNCHES)
    out["pad_copies"] = kernels.PAD_COPIES
    out["dispatches"] = dispatches
    out["rounds"] = rounds
    server.drain()
    return out


#: a `ContinuousBatcher` option -> its `net.serve` argument
SERVE_OPTION = {"page_size": "gen_page_size", "n_pages": "gen_pages",
                "prefix_cache": "gen_prefix_cache",
                "prefix_match": "gen_prefix_match",
                "draft_net": "gen_draft", "spec_k": "gen_spec_k",
                "steps_per_dispatch": "gen_steps_per_dispatch"}


def dispatch_summary(dispatches) -> dict:
    """By K: dispatches, mean wall and wait (ms) and the host's share."""
    out = {}
    for k in sorted({d[0] for d in dispatches}):
        rows = [d for d in dispatches if d[0] == k]
        wall = sum(d[1] for d in rows)
        wait = sum(d[2] for d in rows)
        out[str(k)] = {"dispatches": len(rows),
                       "wall_ms_mean": wall / len(rows) * 1e3,
                       "wait_ms_mean": wait / len(rows) * 1e3,
                       "host_share": 1.0 - wait / wall if wall else 0.0}
    return out


def round_summary(rounds) -> Optional[dict]:
    """Speculative rounds: how many, mean wall and wait (ms), the host's
    share, tokens a round."""
    if not rounds:
        return None
    wall = sum(r[0] for r in rounds)
    wait = sum(r[1] for r in rounds)
    return {"rounds": len(rounds), "wall_ms_mean": wall / len(rounds) * 1e3,
            "wait_ms_mean": wait / len(rounds) * 1e3,
            "host_share": 1.0 - wait / wall if wall else 0.0,
            "tokens_per_round": sum(r[2] for r in rounds) / len(rounds)}


def option_pass(torch, kernels, net, g, name, groups, refs, exact=None,
                **options):
    """One option pass: `warmup_generate` for the batcher `options` (timed:
    the captures it adds, their seconds, the graph pool's growth; a draft
    net's included), then `serve_generation`; checks the first `exact`
    streams' tokens (all by default) against their references bitwise (the
    others are reported), and that serving captured nothing. Returns (the
    pass's row, emitted; the served result)."""
    ics = [net.infer_cache] + ([options["draft_net"].infer_cache]
                               if options.get("draft_net") else [])
    ic = ics[0]

    def books():
        return (sum(c.stats.misses for c in ics),
                sum(c.stats.total_compile_seconds for c in ics),
                sum(c.pool.reserved_bytes for c in ics))

    misses0, secs0, pool0 = books()
    t0 = time.perf_counter()
    net.warmup_generate(slots=g["slots"], max_seq=g["max_seq"],
                        prompt_buckets=g["buckets"],
                        **{k: v for k, v in options.items()
                           if k != "prefix_match"})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warmed, secs1, pool1 = books()
    served = serve_generation(torch, kernels, net, g, groups, **options)
    got = [t for grp in served["streams"] for t in grp]
    equal = [a == b for a, b in zip(got, refs)]
    exact = len(refs) if exact is None else exact
    st = served["stats"]
    row = {"phase": name, "options": {
               k: v if k != "draft_net" else str(v.conf.conf(1).layer_type)
               for k, v in options.items()},
           "requests": len(got), "tokens_equal_k1": all(equal[:exact]),
           "streams_held": exact, "streams_equal": sum(equal),
           "first_difference": next(
               ([i, j] for i, (a, b) in enumerate(zip(got, refs))
                for j in range(len(a)) if a[j] != b[j]), None),
           "captures": warmed - misses0, "capture_s": warm_s,
           "capture_s_programs": secs1 - secs0,
           "graph_pool_bytes": pool1,
           "graph_pool_bytes_added": pool1 - pool0,
           "fresh_compiles_after_warmup": st["fresh_compiles"] - warmed,
           "wall_s": served["wall_s"],
           "tokens_per_s_wall": sum(len(t) for t in got) / served["wall_s"],
           "stats": {k: st[k] for k in (
               "tokens", "tokens_per_sec", "ttft_ms", "streams",
               "steps_per_dispatch", "host_overhead_fraction",
               "decode_host_seconds_total", "decode_block_steps",
               "fresh_compiles", "kv_pages", "prefix_cache", "speculative")
               if k in st},
           "ttft_ms_by_group": served["ttft_ms"],
           "latency_ms": served["latency_ms"],
           "dispatch": dispatch_summary(served["dispatches"]),
           "rounds": round_summary(served["rounds"]),
           "launches": served["launches"],
           "pad_copies": served["pad_copies"]}
    emit(row)
    check(len(got) == len(refs) and all(equal[:exact]),
          f"{name}: tokens differ from the K = 1 pass in "
          f"{exact - sum(equal[:exact])} of {exact} streams "
          f"(first at {row['first_difference']})")
    check(row["fresh_compiles_after_warmup"] == 0,
          f"{name}: serving captured {row['fresh_compiles_after_warmup']} "
          f"programs after warm-up")
    check(st["streams"]["failed"] == 0
          and st["streams"]["completed"] == len(got),
          f"{name}: streams {st['streams']}")
    check(served["pad_copies"] == 0, f"{name}: padding copies")
    return row, served


def block_profile(torch, kernels, net, g, name, quick, pages=None):
    """One K-step block over the whole table (every row budgeted K), timed
    by events over back-to-back calls and traced once: its device time and
    idle share. `pages` = (n_pages, page_size) times the paged block over
    that pool (slot s on its own run of pages). Emits the row."""
    ic, conf, k = net.infer_cache, net.conf, GEN_OPTIONS["k"]
    slots = g["slots"]
    tok = np.arange(slots, dtype=np.int32)
    pos = np.full((slots,), min(40 if quick else 300, g["max_seq"] - k),
                  np.int32)
    keys = np.zeros((slots, 2), np.uint32)
    tmp = np.asarray([0.0, g["temperature"]] * (slots // 2), np.float32)
    rem = np.full((slots,), k, np.int32)
    misses = ic.stats.misses
    if pages is None:
        table = ic.decode_state(conf, slots, g["max_seq"], "cuda", "table")

        def block():
            return ic.decode_multi(conf, net.params, table, tok, pos, keys,
                                   tmp, rem, k)
    else:
        pool = ic.decode_state(conf, slots, g["max_seq"], "cuda", "pool",
                               pages=pages)
        per_slot = -(-g["max_seq"] // pages[1])
        page_table = (1 + np.arange(slots * per_slot, dtype=np.int32)
                      ).reshape(slots, per_slot)

        def block():
            return ic.decode_multi_paged(conf, net.params, pool, tok, pos,
                                         keys, tmp, rem, page_table, k)

    ms = cuda_ms(block, iters=5, warmup=1)
    prof = profiled(torch, kernels, block, name)
    check(ic.stats.misses == misses, f"{name}: timing captured a program")
    row = {"phase": name + "_summary", "k": k, "block_ms": ms,
           "device_ms": prof["device_ms"],
           "idle_share": 1.0 - prof["device_ms"] / ms,
           "idle_share_profiled": prof["idle_share"],
           "kernel_count": prof["kernel_count"]}
    emit(row)
    return row


def phase_generate_options(torch, kernels, net, g, reqs, k1_streams,
                           quick):
    """The option passes (GEN_OPTIONS) after the K = 1 pass: each serves
    the K = 1 pass's requests (the prefix pass also repeats and extensions
    of them) on the same net through a server of its options, warmed
    first, holds every stream to the K = 1 pass's tokens bitwise (a
    longest match's logp to a cold prefill's within bf16 rounding), and
    checks its flash launches (one a block an admission, none on a prefix
    hit); then times a prefix entry's copies. Returns each pass's flash
    launches."""
    from deeplearning4j_tpu_torch.serving import ContinuousBatcher

    o = GEN_OPTIONS_QUICK if quick else GEN_OPTIONS
    nb, k = g["n_blocks"], o["k"]
    launches = {}
    # -- K steps a dispatch --------------------------------------------------
    _, served = option_pass(torch, kernels, net, g, "generate_block",
                            [reqs], k1_streams, steps_per_dispatch=k)
    launches["generate_block"] = served["launches"]["flash_attn_fwd"]
    check(launches["generate_block"] == nb * len(reqs),
          f"generate_block: flash launches {launches['generate_block']}")
    check(served["stats"]["decode_block_steps"]["counts"][3] > 0,
          "generate_block: no block of K = 8 ran")
    block_profile(torch, kernels, net, g, "generate_block_profile", quick)
    # -- the paged pool: its default size, then overcommitted ----------------
    for name, pages in (("generate_paged", 0),
                        ("generate_paged_overcommit", o["overcommit"])):
        _, served = option_pass(torch, kernels, net, g, name, [reqs],
                                k1_streams, page_size=o["page_size"],
                                n_pages=pages, steps_per_dispatch=k)
        kv = served["stats"]["kv_pages"]
        launches[name] = served["launches"]["flash_attn_fwd"]
        # every admission prefills: a preempted stream is admitted again
        check(launches[name] == nb * (len(reqs) + kv["preempted_streams"]),
              f"{name}: flash launches {launches[name]}, pages {kv}")
        check(kv["live"] == 0, f"{name}: pages left live: {kv}")
        if pages and not quick:
            check(kv["preempted_streams"] >= 1,
                  f"{name}: the overcommitted pool preempted nothing: {kv}")
    per_slot = -(-g["max_seq"] // o["page_size"])
    block_profile(torch, kernels, net, g, "generate_paged_block_profile",
                  quick, (g["slots"] * per_slot + 1, o["page_size"]))
    # -- the prefix cache ------------------------------------------------------
    repeats = reqs[:o["repeats"]]
    rng = np.random.RandomState(7)
    fits = [r for r in sorted(reqs, key=lambda r: len(r[0]))
            if len(r[0]) + o["suffix"] <= g["buckets"][-1]][:o["extend"]]
    check(bool(fits), "no prompt leaves room for an extension")
    suffixes = [rng.randint(0, SLICE["vocab"], o["suffix"]).tolist()
                for _ in fits]
    extended = [(p + sfx, t, 100 + i)
                for i, ((p, t, _), sfx) in enumerate(zip(fits, suffixes))]
    # the extensions have no stream in the K = 1 pass: a cold prefill of
    # the whole prompt through the K = 1 dense path is reported beside
    # them. A longest match feeds the suffix through decode steps instead
    # of the prefill's flash forward, the same function by other kernels,
    # so in bf16 the two agree within rounding (held below), not bit for
    # bit
    ref = ContinuousBatcher(net, n_slots=g["slots"], max_seq=g["max_seq"],
                            prompt_buckets=g["buckets"])
    try:
        pending = [ref.submit(p, max_new_tokens=g["max_new"], temperature=t,
                              rng_seed=s) for p, t, s in extended]
        ext_refs = [list(x.tokens(timeout=300)) for x in pending]
    finally:
        ref.stop()
    row, served = option_pass(
        torch, kernels, net, g, "generate_prefix", [reqs, repeats, extended],
        k1_streams + k1_streams[:len(repeats)] + ext_refs,
        exact=len(reqs) + len(repeats), prefix_cache=True,
        prefix_match="longest")
    pc = served["stats"]["prefix_cache"]
    launches["generate_prefix"] = served["launches"]["flash_attn_fwd"]
    check(pc["hits"] == len(repeats) + len(extended)
          and pc["misses"] == len(reqs), f"generate_prefix: {pc}")
    check(launches["generate_prefix"] == nb * pc["misses"],
          f"generate_prefix: flash launches {launches['generate_prefix']}")
    gaps = [feed_vs_prefill_gap(torch, net, g, p, sfx)
            for (p, _, _), sfx in zip(fits, suffixes)]
    feed = {"extension_streams_equal_cold_prefill": [
                a == b for a, b in zip(served["streams"][2], ext_refs)],
            "feed_vs_prefill": [{"max_abs_gap": a, "max_abs_logp": b}
                                for a, b in gaps]}
    emit({"phase": "generate_prefix_feed", **feed})
    check(all(a <= 2e-2 * b for a, b in gaps),
          f"generate_prefix: the fed suffix's logp vs a cold prefill: {feed}")
    emit(prefix_copy_times(torch, net, g))
    return launches


def feed_vs_prefill_gap(torch, net, g, prefix, suffix):
    """A longest prefix match against a cold admission, eager at B = 1: the
    logp after the prefill of `prefix` and one decode step a `suffix`
    token, against the prefill of the whole prompt. Returns (max |gap|,
    max |logp|)."""
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    conf, params = net.conf, net.params
    n, full = len(prefix), prefix + suffix

    def ids(x):
        return torch.as_tensor(x, device="cuda")

    with torch.inference_mode():
        state = decode_mod.init_state(conf, 1, g["max_seq"], "cuda")
        cold, _ = decode_mod.prefill(conf, params, state, ids([full]),
                                     ids([len(full)]))
        state = decode_mod.init_state(conf, 1, g["max_seq"], "cuda")
        fed, state = decode_mod.prefill(conf, params, state, ids([prefix]),
                                        ids([n]))
        for j, t in enumerate(suffix):
            fed, state = decode_mod.decode_step(conf, params, state, ids([t]),
                                                ids([n + j]))
    return ((cold.float() - fed.float()).abs().max().item(),
            cold.float().abs().max().item())


def prefix_copy_times(torch, net, g, turns=3):
    """What a prefix-cache entry's copies cost at this width, pinned and
    pageable host memory in turns: the store (host allocation and the
    device-to-host copy of the admission row) and a hit's copy of it into a
    table row (host to device). Milliseconds by host clock around a
    synchronise, the minimum over `turns`."""
    ic, conf = net.infer_cache, net.conf
    row = ic.decode_state(conf, 1, g["max_seq"], "cuda", "row")
    table = ic.decode_state(conf, g["slots"], g["max_seq"], "cuda", "table")
    leaves = [t for lay in row for t in lay.values()]
    dst = [t for lay in table for t in lay.values()]
    out = {"phase": "generate_prefix_copy",
           "row_bytes": sum(t.numel() * t.element_size() for t in leaves)}
    for mode in ("pinned", "pageable", "pageable", "pinned"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "pinned":
            host = [torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t) for t in leaves]
        else:
            host = [t.cpu() for t in leaves]
        store = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for d, h in zip(dst, host):
            d[0].copy_(h[0], non_blocking=True)
        torch.cuda.synchronize()
        hit = (time.perf_counter() - t0) * 1e3
        for key, v in ((f"{mode}_store_ms", store), (f"{mode}_hit_ms", hit)):
            out[key] = min(out.get(key, v), v)
        del host
    return out


def spec_draft(vocab, seed, **widths):
    """A char-LSTM draft on the card: the bench's LSTM widths (embed and
    hidden 256, 4 layers) unless `widths` says otherwise, f32."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    w = {"hidden": LSTM["hidden"], "n_layers": LSTM["n_layers"],
         "embed": LSTM["embed"], **widths}
    return MultiLayerNetwork(char_lstm(vocab, **w), device="cuda",
                             seed=seed).init()


def batcher_streams(torch, net, prompts, temps, n_new, slots, max_seq,
                    buckets, **options):
    """Every prompt through a `ContinuousBatcher` of `options` (stream i
    seeded i), all queued before it starts: the tokens, the stats after it
    stopped, the wall seconds."""
    from deeplearning4j_tpu_torch.serving import ContinuousBatcher

    cb = ContinuousBatcher(net, n_slots=slots, max_seq=max_seq,
                           prompt_buckets=buckets, auto_start=False,
                           **options)
    try:
        streams = [cb.submit(p, max_new_tokens=n_new, temperature=t,
                             rng_seed=i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        t0 = time.perf_counter()
        cb.start()
        toks = [list(x.tokens(timeout=600)) for x in streams]
        wall = time.perf_counter() - t0
    finally:
        cb.stop()
    return toks, cb.stats(), wall


def spec_divergence(torch, net, g, prompt, want, got, k):
    """Where a speculative stream `got` first differs from the K = 1 pass's
    `want`: the index, and there the logp of the K = 1 path (the prefill,
    then one decode step a token of `want`) against the verify path's (the
    same prefill, then chunks of k tokens of `want` from its first),
    teacher-forced, eager at B = 1. Returns (index, max |gap| at it, max
    |logp| there, max |gap| up to it)."""
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    conf, params, n = net.conf, net.params, len(prompt)

    def ids(x):
        return torch.as_tensor(x, device="cuda")

    with torch.inference_mode():
        state = decode_mod.init_state(conf, 1, g["max_seq"], "cuda")
        lp0, state = decode_mod.prefill(conf, params, state, ids([prompt]),
                                        ids([n]))
        vstate = tuple({name: t.clone() for name, t in lay.items()}
                       for lay in state)
        rows, vrows = [lp0[0]], [lp0[0]]
        for i, t in enumerate(want[:j]):
            lp, state = decode_mod.decode_step(conf, params, state, ids([t]),
                                               ids([n + i]))
            rows.append(lp[0])
        for c in range(0, j, k):
            chunk = want[c:min(c + k, j)]
            lp, vstate, _ = decode_mod.verify_chunk(
                conf, params, vstate, ids([chunk]), ids([n + c]))
            vrows.extend(lp[0])
        a, b = torch.stack(rows).float(), torch.stack(vrows).float()
        gap = (a - b).abs().amax(dim=-1)
    return j, gap[j].item(), a[j].abs().max().item(), gap.max().item()


def verify_vs_steps(torch, net, draft, g, prompts, k):
    """(3): `verify_chunk` against k one-token `decode_step`s on copies of
    one state (B = the prompts, prefilled), with the draft's greedy
    proposals teacher-forced, eager: (max |logp gap|, max |logp|, the
    proposals the target's greedy tokens agree with)."""
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    b, bucket = len(prompts), g["buckets"][-1]
    pb = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(prompts):
        pb[i, :len(p)] = p
    length = torch.as_tensor([len(p) for p in prompts], device="cuda")
    pb = torch.as_tensor(pb, device="cuda")
    with torch.inference_mode():
        state = decode_mod.init_state(net.conf, b, g["max_seq"], "cuda")
        lp0, state = decode_mod.prefill(net.conf, net.params, state, pb,
                                        length)
        dstate = decode_mod.init_state(draft.conf, b, g["max_seq"], "cuda")
        _, dstate = decode_mod.prefill(draft.conf, draft.params, dstate, pb,
                                       length)
        cols = [torch.argmax(lp0, dim=-1)]
        for i in range(1, k):
            dlp, dstate = decode_mod.decode_step(
                draft.conf, draft.params, dstate, cols[-1], length + i - 1)
            cols.append(torch.argmax(dlp, dim=-1))
        toks = torch.stack(cols, dim=1)
        copy = tuple({name: t.clone() for name, t in lay.items()}
                     for lay in state)
        vlp, _, _ = decode_mod.verify_chunk(net.conf, net.params, copy, toks,
                                            length)
        rows = []
        for i in range(k):
            lp, state = decode_mod.decode_step(net.conf, net.params, state,
                                               toks[:, i], length + i)
            rows.append(lp)
        d = torch.stack(rows, dim=1).float()
        agree = (torch.argmax(d[:, :-1], dim=-1) == toks[:, 1:]).sum()
    return ((vlp.float() - d).abs().max().item(), d.abs().max().item(),
            int(agree))


def spec_step_times(torch, kernels, net, draft, g, k, decode_bytes):
    """A verify's and a draft step's device time by graph replay (the
    warmed programs, on the batcher's states), beside the decode step's in
    turns (decode, verify, verify, decode), each profiled once, and the
    verify's bounds: the decode step's bytes (the weights read once as the
    step reads them, or once in bf16, and the K/V tables once), which the
    verify moves too."""
    ic, dic, conf = net.infer_cache, draft.infer_cache, net.conf
    slots = g["slots"]
    table = ic.decode_state(conf, slots, g["max_seq"], "cuda", "table")
    dtable = dic.decode_state(draft.conf, slots, g["max_seq"], "cuda",
                              "draft")
    tok = np.arange(slots, dtype=np.int32)
    toks = (np.arange(slots * k, dtype=np.int32) % SLICE["vocab"]).reshape(
        slots, k)
    pos = np.full((slots,), 300 if g["max_seq"] > 304 else 40, np.int32)
    keys = np.zeros((slots, 2), np.uint32)
    tmp = np.asarray([0.0, g["temperature"]] * (slots // 2), np.float32)
    zeros = np.zeros((slots,), np.float32)
    misses = ic.stats.misses + dic.stats.misses

    def decode():
        return ic.decode(conf, net.params, table, tok, pos, keys, tmp)

    def verify():
        return ic.verify(conf, net.params, table, toks, pos, keys, tmp)

    def draft_step():
        return dic.decode(draft.conf, draft.params, dtable, tok, pos, keys,
                          zeros)

    turns = {"decode": [], "verify": []}
    for name in ("decode", "verify", "verify", "decode"):
        turns[name].append(cuda_ms(decode if name == "decode" else verify,
                                   iters=20, warmup=3))
    draft_ms = cuda_ms(draft_step, iters=20, warmup=3)
    # every admission prefills the draft's row too, a step a prompt token
    drow = dic.decode_state(draft.conf, 1, g["max_seq"], "cuda", "draft-row")
    draft_prefill_ms = {}
    for tb in g["buckets"]:
        pb = np.zeros((1, tb), np.int32)
        draft_prefill_ms[str(tb)] = cuda_ms(
            lambda pb=pb, tb=tb: dic.prefill(
                draft.conf, draft.params, drow, pb,
                np.asarray([tb], np.int32), keys[:1], zeros[:1]),
            iters=5, warmup=1)
    prof = {name: profiled(torch, kernels, fn, f"generate_spec_{name}"
                           "_profile")
            for name, fn in (("decode", decode), ("verify", verify),
                             ("draft_step", draft_step))}
    check(ic.stats.misses + dic.stats.misses == misses,
          "timing the verify or the draft step captured a program")
    casts, bf16 = decode_bytes
    return {"verify_ms": min(turns["verify"]),
            "decode_step_ms": min(turns["decode"]), "turns": turns,
            "verify_device_ms": prof["verify"]["device_ms"],
            "decode_step_device_ms": prof["decode"]["device_ms"],
            "verify_kernel_count": prof["verify"]["kernel_count"],
            "decode_kernel_count": prof["decode"]["kernel_count"],
            "verify_bound_ms": casts / PEAK_BYTES * 1e3,
            "verify_bound_bf16_weights_ms": bf16 / PEAK_BYTES * 1e3,
            "draft_step_ms": draft_ms,
            "draft_prefill_ms": draft_prefill_ms,
            "draft_step_device_ms": prof["draft_step"]["device_ms"],
            "draft_kernel_count": prof["draft_step"]["kernel_count"]}


def phase_generate_spec(torch, kernels, net, g, reqs, k1_streams, quick,
                        decode_bytes):
    """Speculative decoding on the generate pass's net and requests
    (GEN_SPEC): a char-LSTM draft, `warmup_generate(draft_net=, spec_k=)`,
    then the requests through POST /v1/generate, dense and paged; each
    stream against the K = 1 pass's: bitwise, or its first divergence with
    the logp gap there within 2e-2 max|logp| (bf16 verify GEMMs have B x k
    rows where the step has B); no capture after warm-up, one flash
    launch a block an admission. Then (3) a verify against k decode steps,
    and the verify's and a draft step's device times. Returns each pass's
    flash launches."""
    o, nb = GEN_SPEC, g["n_blocks"]
    draft = spec_draft(SLICE["vocab"], o["draft_seed"])
    launches, rows = {}, {}
    for name, extra in (("generate_spec", {}),
                        ("generate_spec_paged",
                         {"page_size": o["page_size"]})):
        row, served = option_pass(torch, kernels, net, g, name, [reqs],
                                  k1_streams, exact=0, draft_net=draft,
                                  spec_k=o["k"], **extra)
        got = served["streams"][0]
        divergences = []
        for i, (a, b) in enumerate(zip(k1_streams, got)):
            if a != b:
                j, gap, scale, gap_max = spec_divergence(
                    torch, net, g, reqs[i][0], a, b, o["k"])
                divergences.append({"request": i, "token": j,
                                    "logp_gap": gap, "max_abs_logp": scale,
                                    "max_gap_before": gap_max})
        spec = served["stats"]["speculative"]
        rows[name] = {"phase": name + "_streams",
                      "streams_equal_k1": sum(a == b for a, b in zip(
                          k1_streams, got)),
                      "divergences": divergences,
                      "accepted_per_step": spec["accepted_per_step"],
                      "rounds": spec["rounds"]}
        emit(rows[name])
        check(all(d["logp_gap"] <= 2e-2 * d["max_abs_logp"]
                  for d in divergences),
              f"{name}: a divergence past 2e-2 max|logp|: {divergences}")
        launches[name] = served["launches"]["flash_attn_fwd"]
        check(launches[name] == nb * len(reqs),
              f"{name}: flash launches {launches[name]}")
        check(spec["rounds"] > 0 and row["rounds"] is not None,
              f"{name}: no speculative round ran")
    gap, scale, agree = verify_vs_steps(
        torch, net, draft, g, [r[0] for r in reqs[:g["slots"]]], o["k"])
    times = spec_step_times(torch, kernels, net, draft, g, o["k"],
                            decode_bytes)
    dic = draft.infer_cache
    row = {"phase": "generate_spec_steps", "k": o["k"],
           "verify_vs_steps_max_abs_gap": gap, "max_abs_logp": scale,
           "proposals_agreeing_greedy": agree,
           "draft": {"vocab": SLICE["vocab"], "hidden": LSTM["hidden"],
                     "n_layers": LSTM["n_layers"], "embed": LSTM["embed"]},
           # the verify programs' and the draft's captures, warm-up calls
           # included; the draft's graphs are in a pool of their own
           "capture_s_by_program": {
               repr(k[:1] + k[2][:1]): v
               for c in (net.infer_cache, dic)
               for k, v in c.stats.compile_seconds.items()
               if c is dic or k[0].startswith("verify")},
           "draft_graph_pool_bytes": dic.pool.reserved_bytes,
           **times}
    emit(row)
    check(gap <= 2e-2 * scale, f"(3) verify vs decode steps: {row}")
    del draft
    return launches


def spec_f32_identity(torch, g, reqs):
    """The f32 greedy variant: the charTransformer at 2 blocks of SLICE's
    widths in f32 with an f32 char-LSTM draft; the first
    GEN_SPEC["f32_requests"] prompts, greedy, through a batcher with the
    draft and one without: the streams must be bitwise equal."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    o = GEN_SPEC
    net = MultiLayerNetwork(gen_conf(2, ""), device="cuda", seed=1).init()
    draft = spec_draft(SLICE["vocab"], o["draft_seed"])
    prompts = [r[0] for r in reqs[:o["f32_requests"]]]
    temps = [0.0] * len(prompts)
    args = (prompts, temps, o["f32_new"], g["slots"], g["max_seq"],
            g["buckets"])
    plain, _, plain_s = batcher_streams(torch, net, *args)
    spec, st, spec_s = batcher_streams(torch, net, *args, draft_net=draft,
                                       spec_k=o["k"])
    row = {"phase": "generate_spec_f32_two_blocks",
           "streams_equal": [a == b for a, b in zip(plain, spec)],
           "speculative": st["speculative"], "wall_s": spec_s,
           "k1_wall_s": plain_s}
    emit(row)
    check(plain == spec, f"f32 speculative streams differ from K = 1: "
                         f"{row}")
    del net, draft


def phase_spec_char_lstm(torch):
    """(4): the char-LSTM target at lstm_conf's widths in f32 with a
    cloned draft (its conf and params: every greedy proposal accepted) and
    a disagreeing `char_lstm(50, hidden=8, n_layers=1)` from another seed,
    greedy and at 0.8: every stream bitwise the K = 1 pass's, and the
    clone's greedy acceptance above 1 a step."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    o = SPEC_LSTM
    target = MultiLayerNetwork(lstm_conf(compute_dtype=None), device="cuda",
                               seed=3).init()
    clone = MultiLayerNetwork(lstm_conf(compute_dtype=None), device="cuda",
                              seed=3).init()
    clone.params = [{name: t.clone() for name, t in lay.items()}
                    for lay in target.params]
    drafts = {"clone": clone,
              "disagreeing": spec_draft(LSTM["vocab"], 4, hidden=8,
                                        n_layers=1, embed=0)}
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, LSTM["vocab"], rng.randint(10, 31)).tolist()
               for _ in range(o["requests"])]
    # every program captured first, so that the passes are timed alone
    geometry = dict(slots=o["slots"], max_seq=o["max_seq"],
                    prompt_buckets=o["buckets"])
    target.warmup_generate(**geometry)
    for draft in drafts.values():
        target.warmup_generate(**geometry, draft_net=draft, spec_k=o["k"])
    runs = {}
    for temp in (0.0, o["temperature"]):
        args = (prompts, [temp] * len(prompts), o["new"], o["slots"],
                o["max_seq"], o["buckets"])
        plain, _, plain_s = batcher_streams(torch, target, *args)
        for name, draft in drafts.items():
            got, st, wall = batcher_streams(torch, target, *args,
                                            draft_net=draft, spec_k=o["k"])
            runs[f"{name}_{temp}"] = {
                "streams_equal": got == plain,
                "accepted_per_step": st["speculative"]["accepted_per_step"],
                "rounds": st["speculative"]["rounds"],
                "tokens_per_s": sum(map(len, got)) / wall,
                "k1_tokens_per_s": sum(map(len, plain)) / plain_s}
    row = {"phase": "generate_spec_char_lstm", "config": o, "runs": runs}
    emit(row)
    check(all(r["streams_equal"] for r in runs.values()),
          f"char-LSTM speculative streams differ from K = 1: {runs}")
    check(runs["clone_0.0"]["accepted_per_step"] > 1.0,
          f"the cloned draft accepts no chunk: {runs}")


def phase_generate(torch, kernels, quick=False):
    """The charTransformer served through POST /v1/generate (a
    `ContinuousBatcher` over captured decode and prefill graphs, warmed
    first), then the step's times, the checks (a)-(e), the option passes
    (`phase_generate_options`) and the forward kernel at the prefill
    shapes. Returns (the K = 1 pass's launches, the timed prefill-shape
    kernel rows, each option pass's flash launches)."""
    from deeplearning4j_tpu_torch.nd import random as nd_random
    from deeplearning4j_tpu_torch.nn import decode as decode_mod
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    g = GEN_QUICK if quick else GEN
    conf = gen_conf(g["n_blocks"])
    t0 = time.perf_counter()
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for layer in net.params for t in layer.values())
    ic = net.infer_cache
    t0 = time.perf_counter()
    warm = net.warmup_generate(slots=g["slots"], max_seq=g["max_seq"],
                               prompt_buckets=g["buckets"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_misses = ic.stats.misses
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, SLICE["vocab"], rng.randint(
        g["prompt_min"], g["prompt_max"] + 1)).tolist()
        for _ in range(g["requests"])]
    temps = [0.0 if i % 2 == 0 else g["temperature"]
             for i in range(g["requests"])]

    reqs = [(prompts[i], temps[i], i) for i in range(g["requests"])]
    served = serve_generation(torch, kernels, net, g, [reqs])
    streams, latency_ms = served["streams"][0], served["latency_ms"][0]
    wall_s, stats = served["wall_s"], served["stats"]
    launches, pad_copies = served["launches"], served["pad_copies"]
    check(stats["streams"] == {"admitted": g["requests"],
                               "completed": g["requests"], "failed": 0},
          f"generation streams {stats['streams']}")
    check(stats["fresh_compiles"] == warm_misses,
          f"serving captured programs: {stats['fresh_compiles']} misses "
          f"after {warm_misses} in warm-up")
    # every admission is one B = 1 prefill: one forward kernel a block
    check(launches["flash_attn_fwd"] == g["n_blocks"] * g["requests"],
          f"flash launches {launches['flash_attn_fwd']} != "
          f"{g['n_blocks']} x {g['requests']} admissions")
    check(pad_copies == 0, f"the generate path made {pad_copies} padding "
                           f"copies")

    # -- the step's times (outside the main path's launch count) ----------
    table = ic.decode_state(conf, g["slots"], g["max_seq"], "cuda", "table")
    tok = np.arange(g["slots"], dtype=np.int32)
    pos = np.full((g["slots"],), 300 if not quick else 40, np.int32)
    keys = np.zeros((g["slots"], 2), np.uint32)
    tmp = np.asarray([0.0, g["temperature"]] * (g["slots"] // 2),
                     np.float32)
    books_before = ic.stats.misses

    def captured():
        return ic.decode(conf, net.params, table, tok, pos, keys, tmp)

    tok_t, pos_t = (torch.as_tensor(a, device="cuda") for a in (tok, pos))
    keys_t = nd_random.key_array(keys, "cuda")
    tmp_t = torch.as_tensor(tmp, device="cuda")

    def eager():
        with torch.inference_mode():
            logp, _ = decode_mod.decode_step(conf, net.params, table, tok_t,
                                             pos_t)
            return nd_random.sample_tokens(logp.float(), keys_t, tmp_t)

    turns = {"captured": [], "eager": []}
    for name in ("captured", "eager", "eager", "captured"):
        turns[name].append(cuda_ms(captured if name == "captured" else eager,
                                   iters=20, warmup=3))
    check(ic.stats.misses == books_before, "timing the decode step captured "
                                           "a new program")
    prof = profiled(torch, kernels, captured, "generate_decode_profile")
    prof_eager = profiled(torch, kernels, eager,
                          "generate_decode_profile_eager")
    captured_ms, eager_ms = min(turns["captured"]), min(turns["eager"])
    row_state = ic.decode_state(conf, 1, g["max_seq"], "cuda", "row")
    prefill_ms, prefill_device_ms = {}, {}
    for tb in g["buckets"]:
        pb = np.zeros((1, tb), np.int32)

        def prefill(pb=pb, tb=tb):
            return ic.prefill(conf, net.params, row_state, pb,
                              np.asarray([tb], np.int32), keys[:1], tmp[:1])

        prefill_ms[str(tb)] = cuda_ms(prefill, iters=5, warmup=1)
        prefill_device_ms[str(tb)] = profiled(
            torch, kernels, prefill,
            f"generate_prefill_profile_{tb}")["device_ms"]
    bytes_casts, bytes_bf16 = decode_bounds(net, conf, g["slots"],
                                            g["max_seq"])

    # -- correctness on the card --------------------------------------------
    # (a) the cached decode against the eager loop, at these widths (bf16)
    a_runs = {}
    for temp, seed in ((0.0, 1), (g["temperature"], 2)):
        same_tok, same_keys, gap, logp_gap, _ = decode_eager_check(
            torch, net, prompts[0], 16 if quick else 32, temp, seed)
        a_runs[str(temp)] = {"tokens_equal": same_tok,
                             "keys_equal": same_keys, "state_gap": gap,
                             "logp_gap": logp_gap}
        check(same_tok and same_keys,
              f"(a) cached decode differs from the eager loop: {a_runs}")
    # (b) teacher-forced logp against the re-forward, on served streams
    b_runs = []
    for i in (0, 1):
        gap, scale = teacher_forced_gap(torch, net, prompts[i], streams[i])
        b_runs.append({"request": i, "max_abs_gap": gap,
                       "max_abs_logp": scale})
        check(gap <= 2e-2 * scale, f"(b) decode logp vs re-forward: "
                                   f"{b_runs[-1]}")
    gen_row = {
        "phase": "generate", "config": {**SLICE, **g},
        "compute_dtype": "bfloat16", "params": n_params, "init_s": init_s,
        "warmup": {k: v for k, v in warm.items() if k != "infer_cache"},
        "capture_s": warm_s,
        "capture_s_by_program": {repr(k[:1] + k[2][:1]): v for k, v in
                                 ic.stats.compile_seconds.items()},
        "graph_pool_bytes": ic.pool.reserved_bytes,
        "requests": g["requests"], "clients": g["clients"],
        "prompt_lengths": [len(p) for p in prompts],
        "temperatures": temps, "latency_ms": latency_ms, "wall_s": wall_s,
        "tokens_per_s_wall": g["requests"] * g["max_new"] / wall_s,
        "stats": {k: stats[k] for k in (
            "tokens", "tokens_per_sec", "ttft_ms", "ttft_hist_s", "streams",
            "host_overhead_fraction", "decode_host_seconds_total",
            "fresh_compiles")},
        "launches": launches,
        "decode_step_ms": captured_ms, "decode_step_ms_turns": turns,
        "decode_step_eager_ms": eager_ms,
        "decode_step_device_ms": prof["device_ms"],
        "decode_step_idle_share": 1.0 - prof["device_ms"] / captured_ms,
        "decode_step_idle_share_profiled": prof["idle_share"],
        "decode_step_eager_device_ms": prof_eager["device_ms"],
        "decode_step_eager_idle_share": (1.0 - prof_eager["device_ms"]
                                         / eager_ms),
        "decode_bound_ms": bytes_casts / PEAK_BYTES * 1e3,
        "decode_bound_bf16_weights_ms": bytes_bf16 / PEAK_BYTES * 1e3,
        "decode_step_bytes": [bytes_casts, bytes_bf16],
        "prefill_ms": prefill_ms, "prefill_device_ms": prefill_device_ms,
        "a_cached_vs_eager": a_runs, "b_teacher_forced": b_runs,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    gen_row["dispatch"] = dispatch_summary(served["dispatches"])
    emit(gen_row)
    # the option passes on the same net and requests
    option_launches = phase_generate_options(torch, kernels, net, g, reqs,
                                             streams, quick)
    option_launches.update(phase_generate_spec(
        torch, kernels, net, g, reqs, streams, quick,
        (bytes_casts, bytes_bf16)))
    del net, table, row_state
    gc.collect()
    torch.cuda.empty_cache()
    # token identity against the re-forward, in f32 at 2 blocks; (a) there
    # with the f32 logp gap
    same, toks, ref, (a_tok, a_keys, a_gap, a_logp) = f32_token_identity(
        torch)
    f32_row = {"phase": "generate_f32_two_blocks",
               "tokens_equal_reforward": same, "tokens": toks,
               "reforward": ref, "a_tokens_equal": a_tok,
               "a_keys_equal": a_keys, "a_state_gap": a_gap,
               "a_logp_gap": a_logp}
    emit(f32_row)
    check(same, f"f32 cached greedy tokens differ from the re-forward: "
                f"{toks} vs {ref}")
    check(a_tok and a_keys and a_logp <= 1e-6, f"(a) in f32: {f32_row}")
    gc.collect()
    torch.cuda.empty_cache()
    # speculative decoding: f32 greedy at 2 blocks, then the char-LSTM target
    spec_f32_identity(torch, g, reqs)
    phase_spec_char_lstm(torch)
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the forward kernel at every prefill bucket; (d) the sampler
    prefill_kernel_checks(torch, kernels)
    threefry_check(torch)
    # (e)
    charlstm_generate_check(torch)
    kernel_rows = []
    if not quick:
        gen = torch.Generator(device="cuda").manual_seed(21)
        for s in g["buckets"]:
            kernel_rows.append(fwd_kernel_row(
                torch, kernels, gen, (1, s, SLICE["n_heads"],
                                      SLICE["d_model"] // SLICE["n_heads"],
                                      torch.bfloat16, True, False, True),
                phase="generate_kernel"))
    gc.collect()
    torch.cuda.empty_cache()
    return launches, kernel_rows, option_launches


def profile_step(torch, kernels, net, x, y, phase="train_profile",
                 ours_key="flash_") -> dict:
    """One more training step under `torch.profiler` (`profiled`)."""
    return profiled(torch, kernels, lambda: net.fit(x, y), phase, ours_key)


def profiled(torch, kernels, fn, phase, ours_key="flash_") -> dict:
    """One fn() call under `torch.profiler`: prints the device time by
    kernel name (the 15 largest), the device time of the port's kernels
    (names holding `ours_key`), in all and by kernel, the sum over every
    kernel, and the call's wall time, from which the device's idle share
    follows. Launches made here are not counted as the main path's.
    Returns the row."""
    from torch.profiler import ProfilerActivity, profile

    saved = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels.LAUNCHES.update(saved)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    total_us = sum(e.device_time_total for e in events)
    ours = [e for e in events if ours_key in e.key]
    row = {"phase": phase, "wall_ms": wall_ms,
           "device_ms": total_us / 1e3,
           "idle_share": 1.0 - total_us / 1e3 / wall_ms,
           "port_kernels_ms": sum(e.device_time_total for e in ours) / 1e3,
           "port_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.device_time_total / 1e3} for e in ours],
           "kernel_count": sum(e.count for e in events),
           "top": [{"name": e.key[:90], "calls": e.count,
                    "ms": e.device_time_total / 1e3} for e in events[:15]]}
    emit(row)
    return row


def train_conf(compute_dtype: str, fused_bwd: bool = True,
               n_blocks: Optional[int] = None):
    """The JAX package's flagship training configuration (bench.py:558-567
    with `_mixed`): the full-width charTransformer with sparse labels, the
    fused updater, block skip and the fused attention backward, flash
    attention on every layer, in `compute_dtype` over f32 weights, at
    learning rate TRAIN_LR; `n_blocks` cuts its depth."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=n_blocks or SLICE["n_blocks"],
                            n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"], sparse_labels=True,
                            fused_updater=True, attention_block_skip=True,
                            attention_fused_bwd=fused_bwd)
    conf = conf.with_compute_dtype(compute_dtype)
    return conf.replace(confs=tuple(c.replace(attention_impl="flash",
                                              lr=TRAIN_LR)
                                    for c in conf.confs))


def twin_nets(conf):
    """(captured, eager): a network on the default path, through the step
    and infer caches (CUDA graphs), and one with both caches off, on the
    same weights (seed 0)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    captured = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    eager = MultiLayerNetwork(conf, device="cuda", seed=0)
    eager.params = tuple({k: v.clone() for k, v in layer.items()}
                         for layer in captured.params)
    eager.use_step_cache = eager.use_infer_cache = False
    return captured, eager


def params_gap(torch, net, ref):
    """max |net - ref| over every param, max |ref|, and whether every param
    is bitwise equal."""
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    pairs = list(zip(tree_leaves(net.params), tree_leaves(ref.params)))
    return {"max_abs_diff": max((a - b).abs().max().item()
                                for a, b in pairs),
            "max_abs": max(b.abs().max().item() for _, b in pairs),
            "bitwise": all(torch.equal(a, b) for a, b in pairs)}


def graph_books(net) -> dict:
    """Capture seconds (warm-up calls included), the bytes the captures
    added to the device's reserved memory (one pool per network), and both
    caches' books."""
    return {"train_capture_s": net.step_cache.stats.total_compile_seconds,
            "infer_capture_s": net.infer_cache.stats.total_compile_seconds,
            "graph_pool_bytes": net.step_cache.pool.reserved_bytes,
            "step_cache": net.step_cache.stats.as_dict(),
            "infer_cache": net.infer_cache.stats.as_dict()}


def median(values):
    return sorted(values)[len(values) // 2]


def idle_shares(profile, step_ms):
    """The device's idle share of a step: its profiled device time against
    the median event-timed step (`idle_share`), and against the profiled
    step's own wall time, which the profiler's host work lengthens
    (`idle_share_profiled`)."""
    return {"device_ms": profile["device_ms"],
            "idle_share": 1.0 - profile["device_ms"] / step_ms,
            "idle_share_profiled": profile["idle_share"],
            "profiled_wall_ms": profile["wall_ms"]}


def train_turns(torch, kernels, nets, x, y, steps):
    """`steps` one-step `fit` calls of each network in turns (captured
    first on even steps, eager first on odd ones), each timed with CUDA
    events and followed by a `score`. Returns per network the step times,
    the scores (the first before any step) and each step's launches."""
    rec = {k: {"step_ms": [], "scores": [net.score(x, y)], "launches": []}
           for k, net in nets.items()}
    for step in range(steps):
        order = list(nets) if step % 2 == 0 else list(nets)[::-1]
        for which in order:
            net = nets[which]
            kernels.reset_launches()
            rec[which]["step_ms"].append(event_ms(torch,
                                                  lambda: net.fit(x, y)))
            rec[which]["launches"].append(dict(kernels.LAUNCHES))
            rec[which]["scores"].append(net.score(x, y))
    return rec


def phase_train(torch, kernels):
    """`MultiLayerNetwork.fit` on the full-width charTransformer in bf16
    compute, one batch of TRAIN_ROWS x 512 tokens made as bench.py:571-574
    makes it, TRAIN_STEPS calls of one Adam step each, on two networks from
    the same weights in turns: the default path (one captured CUDA graph a
    step, replayed) and the eager one (both caches off). Each step must
    launch every attention kernel once per layer on both; after the steps
    the two networks' params must agree within bf16 (2e-2 of max|param|).
    Then one profiled step of each, and the fused attention backward
    against the recompute path on the same weights in f32. Returns the
    launches of every kernel over the training steps, and those of the f32
    fused gradient."""
    from deeplearning4j_tpu_torch.nn.multilayer import network_loss
    from deeplearning4j_tpu_torch.optimize.solver import from_loss
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    vocab, seq = SLICE["vocab"], SLICE["seq"]
    net, eager = twin_nets(train_conf("bfloat16"))
    nets = {"captured": net, "eager": eager}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (TRAIN_ROWS, seq + 1))
    x = ids[:, :-1].astype(np.int32)
    y = ids[:, 1:].reshape(TRAIN_ROWS * seq).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.PAD_COPIES = 0
    rec = train_turns(torch, kernels, nets, x, y, TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_pad_copies = kernels.PAD_COPIES
    total = {name: sum(launches[name] for r in rec.values()
                       for launches in r["launches"])
             for name in kernels.LAUNCHES}
    gap = params_gap(torch, net, eager)
    profiles = {"captured": profile_step(torch, kernels, net, x, y),
                "eager": profile_step(torch, kernels, eager, x, y,
                                      phase="train_profile_eager")}
    books = graph_books(net)
    step_memory = program_rows(net.step_cache)
    check_program_rows(step_memory, "train step cache")
    n_attn = SLICE["n_blocks"]
    del eager, nets
    torch.cuda.empty_cache()

    # the fused backward against the recompute path, f32 compute, 2 rows
    xs = torch.as_tensor(x[:2], device="cuda")
    ys = torch.as_tensor(y[:2 * seq], device="cuda")
    grads = {}
    for fused in (True, False):
        conf = train_conf("", fused_bwd=fused)
        objective = from_loss(lambda p, c=conf: network_loss(c, p, xs, ys))
        kernels.reset_launches()
        g, _ = objective.grad_and_score(net.params)
        grads[fused] = tree_leaves(g)
        if fused:
            # the f32 backward kernels of one fused gradient
            f32_launches = dict(kernels.LAUNCHES)
    ratios = []
    for a, b in zip(grads[True], grads[False]):
        gmax = b.abs().max().item()
        err = (a - b).abs().max().item()
        ratios.append(err / gmax if gmax > 0 else (0.0 if err == 0 else
                                                   float("inf")))
    del grads

    def path(r, profile):
        steady = median(r["step_ms"][1:])
        return {"step_ms": r["step_ms"], "step_ms_median_2_on": steady,
                "tokens_per_s": TRAIN_ROWS * seq / (steady / 1e3),
                "scores": r["scores"], "launches_per_step": r["launches"],
                **idle_shares(profile, steady)}

    captured = path(rec["captured"], profiles["captured"])
    row = {"phase": "train", "config": SLICE, "compute_dtype": "bfloat16",
           "rows": TRAIN_ROWS, "tokens_per_step": TRAIN_ROWS * seq,
           "updater": "adam", "lr": TRAIN_LR, "fused_updater": True,
           "fused_bwd": True,
           "params": sum(t.numel() for t in tree_leaves(net.params)),
           **captured, "eager": path(rec["eager"], profiles["eager"]),
           "graph": books, "step_program_memory": step_memory,
           "captured_vs_eager_params": gap,
           "peak_mem_gb": peak_gb, "pad_copies_train": train_pad_copies,
           "grad_check_rows": 2, "grad_check_dtype": "float32",
           "grad_check_launches": f32_launches,
           "grad_fused_vs_recompute_max_rel": max(ratios)}
    emit(row)
    for which, r in rec.items():
        scores = r["scores"]
        check(all(np.isfinite(s) for s in scores),
              f"{which}: non-finite score: {scores}")
        check(scores[-1] < scores[0], f"{which}: the score did not fall: "
              f"{scores}")
        for launches in r["launches"]:
            for name in ("flash_attn_fwd",) + BWD_KERNELS:
                check(launches[name] == n_attn,
                      f"{which}: a step launched {name} {launches[name]} "
                      f"times, want {n_attn}: {launches}")
    check(books["step_cache"]["misses"] == 1
          and books["step_cache"]["hits"] == TRAIN_STEPS,
          f"the train step was captured more than once: {books}")
    check(gap["max_abs_diff"] <= 2e-2 * gap["max_abs"],
          f"captured and eager params differ: {gap}")
    for name in BWD_KERNELS:
        check(f32_launches[name] == n_attn,
              f"the f32 fused gradient launched {name} "
              f"{f32_launches[name]} times, want {n_attn}")
    check(max(ratios) <= 1e-3,
          f"fused and recompute gradients differ: {max(ratios)} of max|g|")
    check(train_pad_copies == 0,
          f"the train path made {train_pad_copies} padding copies")
    return total, f32_launches


# -------------------------------------------------------------------- LSTM

#: the bench's 4-layer char-LSTM (bench.py:252-261 with n_layers=4, the
#: north star of BASELINE configs[1]): _mixed(char_lstm(50, hidden=256,
#: n_layers=4, sparse_labels=True, embed=256)), seq 64, batch 256
LSTM = dict(vocab=50, hidden=256, n_layers=4, embed=256, seq=64, rows=256)
LSTM_STEPS = 5
#: the CLI north star (bench.py:1704-1721): a 65,536-character word corpus
#: from RandomState(0), text scheme windows of 32
CLI_SEQ, CLI_CHARS = 32, 65_536
CORPUS_WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
                "dogs", "and", "cats", "read", "write", "code", "tpu"]


def word_corpus(chars: int = CLI_CHARS) -> str:
    """The CLI north star's corpus, built as bench.py:1706-1712 builds it
    (65,527 characters, 27 distinct)."""
    rng = np.random.RandomState(0)
    return " ".join(rng.choice(CORPUS_WORDS)
                    for _ in range(chars // 5))[:chars]


def lstm_bound_ms(b, i, h, dtype_name):
    """max(operations / peak rate, bytes / HBM rate) for one cell: the
    [B, I + H] x [I + H, 4H] product; x, h, c, Wx, Wh, b read once, h' and
    c' written once."""
    size = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * b * (i + h) * 4 * h
    nbytes = size * (b * i + 2 * b * h + (i + h) * 4 * h + 4 * h + 2 * b * h)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def lstm_cell_inputs(torch, gen, b, i, h, dt, view):
    """x, h, c, wx, wh, bias on the card; wx and wh are the two row blocks
    of one [I + H, 4H] W (views, as the layer passes them) or copies."""
    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device="cuda")).to(dt)

    x, h0, c0 = randn(b, i), randn(b, h), randn(b, h)
    w = randn(i + h, 4 * h, scale=0.1)
    wx, wh = (w[:i], w[i:]) if view else (w[:i].clone(), w[i:].clone())
    return x, h0, c0, wx, wh, randn(4 * h, scale=0.1)


def torch_cell_weights(torch, wx, wh, bias):
    """The same cell's weights in `torch.lstm_cell`'s layout: gate rows
    [i | f | g | o] (ours are columns [i | f | o | g]), transposed."""
    h = wh.shape[0]
    perm = torch.cat([torch.arange(0, 2 * h), torch.arange(3 * h, 4 * h),
                      torch.arange(2 * h, 3 * h)]).to(wx.device)
    return (wx[:, perm].t().contiguous(), wh[:, perm].t().contiguous(),
            bias[perm].contiguous(), torch.zeros_like(bias))


def lstm_layer_ms(torch, kernels):
    """Layer level, one [256, 64, 256] f32 sequence: the port's LSTM layer
    (fused: 64 kernel launches; scan) against cuDNN's `nn.LSTM` on the same
    weights. The layer paths by graph replay, cuDNN by eager events (one
    call); outputs compared for the record."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers.lstm import LSTMLayer

    b, t, n = 256, 64, 256
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = torch.randn(b, t, n, generator=gen, device="cuda")
    _, _, _, wx, wh, bias = lstm_cell_inputs(torch, gen, 1, n, n,
                                             torch.float32, False)
    params = {"W": torch.cat([wx, wh]), "b": bias}
    out = {}
    for impl in ("fused", "scan"):
        conf = NeuralNetConfiguration(layer_type=LayerType.LSTM, n_in=n,
                                      n_out=n, lstm_impl=impl)

        def fwd(conf=conf):
            with torch.inference_mode():
                return LSTMLayer.forward(params, conf, xs)

        out[impl] = fwd()
        out[impl + "_ms"] = graph_ms(fwd, iters=3, replays=2)
    cudnn = torch.nn.LSTM(n, n, batch_first=True).to("cuda")
    w_ih, w_hh, b_ih, b_hh = torch_cell_weights(torch, wx, wh, bias)
    with torch.no_grad():
        for name, val in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                          ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(cudnn, name).copy_(val)

    def lib():
        with torch.no_grad():
            return cudnn(xs)[0]

    want = lib()
    torch.cuda.synchronize()
    return {"shape": [b, t, n], "fused_ms": out["fused_ms"],
            "scan_ms": out["scan_ms"], "cudnn_lstm_call_ms": cuda_ms(lib),
            "fused_vs_cudnn_max_abs_err":
                (out["fused"] - want).abs().max().item(),
            "fused_vs_scan_max_abs_err":
                (out["fused"] - out["scan"]).abs().max().item()}


def phase_lstm_kernel(torch, kernels):
    """The fused cell against its plain version on the card in the seven
    cases of LSTM_CASES (f32 at the bench shape, on W's row-block views, at
    the CLI's ragged shape, at a tiny ragged shape; bf16 at the bench
    shape, the CLI's and the tiny ragged one), timed with the plain version
    and `torch.lstm_cell`; then the layer-level note. Returns {case: row}
    and the layer's numbers."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ptxas = [line.strip() for line in
             kernels.BUILD_LOGS.get("lstm_cell", "").splitlines()
             if "registers" in line or "spill" in line]
    rows = {}
    for name, b, i, h, dname, view in LSTM_CASES:
        dt = getattr(torch, dname)
        args = lstm_cell_inputs(torch, gen, b, i, h, dt, view)
        err, ok, want = lstm_check(torch, kernels, args)
        x, h0, c0, wx, wh, bias = args
        w_ih, w_hh, b_ih, b_hh = torch_cell_weights(torch, wx, wh, bias)

        def lib():
            return torch.lstm_cell(x, (h0, c0), w_ih, w_hh, b_ih, b_hh)

        lib_h = lib()[0]
        bound_ms, bound_by = lstm_bound_ms(b, i, h, dname)
        row = {"phase": "lstm_kernel", "case": name, "shape_bih": [b, i, h],
               "dtype": dname, "w_views": view, "max_abs_err": err,
               "ok": ok,
               "kernel_ms": graph_ms(lambda: kernels.lstm_cell(*args)),
               "call_ms": cuda_ms(lambda: kernels.lstm_cell(*args)),
               "plain_ms": graph_ms(
                   lambda: kernels.lstm_cell_reference(*args)),
               "library_ms": graph_ms(lib),
               "library_h_max_abs_err":
                   (lib_h.float() - want[0].float()).abs().max().item(),
               "bound_ms": bound_ms, "bound_by": bound_by, "ptxas": ptxas}
        emit(row)
        check(ok, f"lstm_cell disagrees with its plain version: {row}")
        rows[name] = row
        del args, want, x, h0, c0, wx, wh, bias
    layer = lstm_layer_ms(torch, kernels)
    emit({"phase": "lstm_layer", **layer})
    check(layer["fused_vs_scan_max_abs_err"] < 1e-4,
          f"the fused and scan layers differ: {layer}")
    torch.cuda.empty_cache()
    return rows, layer


def lstm_conf(impl: str = "auto", compute_dtype: str = "bfloat16"):
    """The bench's char-LSTM configuration, with `lstm_impl` set on every
    layer ("auto" is the kernel on the card)."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    conf = char_lstm(LSTM["vocab"], hidden=LSTM["hidden"],
                     n_layers=LSTM["n_layers"], sparse_labels=True,
                     embed=LSTM["embed"])
    conf = conf.replace(confs=tuple(c.replace(lstm_impl=impl)
                                    for c in conf.confs))
    return conf.with_compute_dtype(compute_dtype) if compute_dtype else conf


def lstm_batch():
    """The first LSTM["rows"] windows of seq + 1 characters of the word
    corpus as ids (sorted character order): x [rows, seq], y [rows * seq]."""
    text = word_corpus()
    index = {c: k for k, c in enumerate(sorted(set(text)))}
    rows, seq = LSTM["rows"], LSTM["seq"]
    ids = np.asarray([index[c] for c in text[:rows * (seq + 1)]],
                     np.int32).reshape(rows, seq + 1)
    return ids[:, :-1].copy(), ids[:, 1:].reshape(-1).copy()


def event_ms(torch, fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def phase_lstm_train(torch, kernels):
    """`MultiLayerNetwork.fit` on the bench's 4-layer char-LSTM: LSTM_STEPS
    one-step calls (SGD with momentum, lr 0.1), a score after each, on two
    networks from the same weights in turns, the default (captured) path
    and the eager one, then one `output` of each; every forward must launch
    the cell kernel n_layers * seq times (a replay counts what its capture
    launched), and after the steps the two networks' params must agree
    within bf16. Then one profiled step of each path, the fused path
    against the scan path in f32 (outputs and gradients), and both LSTM
    paths' step and `output` times, captured and eager, in turns. Returns
    the main path's launches."""
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_loss,
                                                        network_output)
    from deeplearning4j_tpu_torch.optimize.solver import from_loss
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    net, eager = twin_nets(lstm_conf())
    nets = {"captured": net, "eager": eager}
    x, y = lstm_batch()
    per_fwd = LSTM["n_layers"] * LSTM["seq"]
    chars = LSTM["rows"] * LSTM["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    fwd_launches = []
    rec = {k: {"step_ms": [], "scores": []} for k in nets}
    for k, n in nets.items():
        before = kernels.LAUNCHES["lstm_cell"]
        rec[k]["scores"].append(n.score(x, y))
        fwd_launches.append(kernels.LAUNCHES["lstm_cell"] - before)
    for step in range(LSTM_STEPS):
        order = list(nets) if step % 2 == 0 else list(nets)[::-1]
        for k in order:
            n = nets[k]
            before = kernels.LAUNCHES["lstm_cell"]
            rec[k]["step_ms"].append(event_ms(torch, lambda: n.fit(x, y)))
            mid = kernels.LAUNCHES["lstm_cell"]
            rec[k]["scores"].append(n.score(x, y))
            fwd_launches += [mid - before,
                             kernels.LAUNCHES["lstm_cell"] - mid]
    outs = {}
    for k, n in nets.items():
        before = kernels.LAUNCHES["lstm_cell"]
        outs[k] = n.output(x)
        torch.cuda.synchronize()
        fwd_launches.append(kernels.LAUNCHES["lstm_cell"] - before)
    launches = kernels.LAUNCHES["lstm_cell"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gap = params_gap(torch, net, eager)
    out_gap = (outs["captured"] - outs["eager"]).abs().max().item()
    out = outs["captured"]
    check(tuple(out.shape) == (chars, LSTM["vocab"]),
          f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "output has non-finite values")
    del outs
    profiles = {
        "captured": profile_step(torch, kernels, net, x, y,
                                 phase="lstm_train_profile",
                                 ours_key="lstm_cell"),
        "eager": profile_step(torch, kernels, eager, x, y,
                              phase="lstm_train_profile_eager",
                              ours_key="lstm_cell")}
    books = graph_books(net)
    output_ms = {}
    for k in ("captured", "eager", "eager", "captured"):
        output_ms.setdefault(k, []).append(
            cuda_ms(lambda: nets[k].output(x), iters=3, warmup=1))
    del eager, nets

    # the kernel path against the hoisted scan in f32, on these weights
    xs = torch.as_tensor(x, device="cuda")
    ys = torch.as_tensor(y, device="cuda")
    f32_outs, grads = {}, {}
    for impl in ("fused", "scan"):
        conf = lstm_conf(impl, compute_dtype="")
        with torch.inference_mode():
            f32_outs[impl] = network_output(conf, net.params, xs)
        objective = from_loss(lambda p, c=conf: network_loss(c, p, xs, ys))
        grads[impl] = tree_leaves(objective.grad_and_score(net.params)[0])
    out_err = (f32_outs["fused"] - f32_outs["scan"]).abs().max().item()
    out_max = f32_outs["scan"].abs().max().item()
    ratios = []
    for a, b in zip(grads["fused"], grads["scan"]):
        gmax = b.abs().max().item()
        err = (a - b).abs().max().item()
        ratios.append(err / gmax if gmax > 0 else (0.0 if err == 0 else
                                                   float("inf")))
    del f32_outs, grads

    # both LSTM paths' train step and output, captured and eager, in turns
    # (each on a copy of the weights: two warm calls, the first of a
    # captured network capturing, then two timed)
    turns = {}
    order = [("fused", True), ("scan", True), ("fused", False),
             ("scan", False)]
    for impl, cached in order:
        other = MultiLayerNetwork(lstm_conf(impl), device="cuda", seed=0)
        other.params = tuple({k: v.clone() for k, v in layer.items()}
                             for layer in net.params)
        other.use_step_cache = other.use_infer_cache = cached
        t = turns.setdefault(f"{impl}_{'captured' if cached else 'eager'}",
                             {"step_ms": [], "output_ms": []})
        for k in range(4):
            ms = event_ms(torch, lambda: other.fit(x, y))
            if k >= 2:
                t["step_ms"].append(ms)
        t["output_ms"].append(cuda_ms(lambda: other.output(x), iters=3,
                                      warmup=1))
        del other
    torch.cuda.empty_cache()

    def path(k):
        steady = median(rec[k]["step_ms"][1:])
        return {"step_ms": rec[k]["step_ms"], "step_ms_median_2_on": steady,
                "chars_per_s": chars / (steady / 1e3),
                "scores": rec[k]["scores"], "output_ms": output_ms[k],
                **idle_shares(profiles[k], steady)}

    row = {"phase": "lstm_train", "config": LSTM, "compute_dtype": "bfloat16",
           "updater": "sgd+momentum", "lr": 0.1,
           "params": sum(t.numel() for t in tree_leaves(net.params)),
           **path("captured"), "eager": path("eager"), "graph": books,
           "captured_vs_eager_params": gap,
           "captured_vs_eager_output_max_abs_diff": out_gap,
           "launches_per_forward": fwd_launches, "launches": launches,
           "peak_mem_gb": peak_gb,
           "f32_fused_vs_scan_output_max_abs_err": out_err,
           "f32_fused_vs_scan_output_max": out_max,
           "f32_fused_vs_scan_grad_max_rel": max(ratios),
           "turns": turns}
    emit(row)
    for k, r in rec.items():
        scores = r["scores"]
        check(all(np.isfinite(s) for s in scores),
              f"{k}: non-finite score: {scores}")
        check(scores[-1] < scores[0], f"{k}: the score did not fall: "
              f"{scores}")
    check(all(n == per_fwd for n in fwd_launches),
          f"a forward launched lstm_cell {fwd_launches}, want {per_fwd} each")
    check(books["step_cache"]["misses"] == 1,
          f"the train step was captured more than once: {books}")
    check(gap["max_abs_diff"] <= 2e-2 * gap["max_abs"],
          f"captured and eager params differ: {gap}")
    check(out_gap <= 2e-2, f"captured and eager outputs differ by {out_gap}")
    check(out_err <= 1e-5 * out_max,
          f"fused and scan outputs differ by {out_err} (max {out_max})")
    check(max(ratios) <= 1e-3,
          f"fused and scan gradients differ: {max(ratios)} of max|g|")
    return launches


class SigtermAfter:
    """A listener that calls the SIGTERM handler `fit(checkpoint_dir=...)`
    installs once `after` batches are done, standing in for the signal."""

    def __init__(self, after):
        self.after, self.n = after, 0

    def iteration_done(self, model, iteration, score):
        import signal

        self.n += 1
        if self.n == self.after:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)


#: batches of the checkpoint phase's stream, and the one SIGTERM follows
CKPT_BATCHES, CKPT_STOP = 4, 2


def phase_checkpoint(torch, kernels):
    """A checkpointed char-LSTM `fit` on the card, at the bench's widths: a
    stream of CKPT_BATCHES batches (the word corpus, made long enough, cut
    into the bench's 256 x 64 windows), stopped by SIGTERM after CKPT_STOP
    batches and rerun from its checkpoint, against two uninterrupted runs.
    The resumed run may differ from an uninterrupted one by no more than
    two uninterrupted runs differ from each other. Returns the cell
    kernel's launches."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator, PrefetchIterator)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.reliability import TrainingInterrupted

    rows, seq = LSTM["rows"], LSTM["seq"]
    n = CKPT_BATCHES * rows
    # word_corpus(k) may come out a few characters short of k
    text = word_corpus(2 * n * (seq + 1))[:n * (seq + 1)]
    index = {c: k for k, c in enumerate(sorted(set(text)))}
    ids = np.asarray([index[c] for c in text],
                     np.int32).reshape(n, seq + 1)
    data = DataSet(ids[:, :-1].copy(), ids[:, 1:].reshape(-1).copy())

    def stream():
        return PrefetchIterator(ListDataSetIterator(data, rows),
                                device="cuda")

    def fresh():
        return MultiLayerNetwork(lstm_conf(), device="cuda", seed=0).init()

    kernels.reset_launches()
    runs = []
    for _ in range(2):
        net = fresh()
        t = time.perf_counter()
        net.fit(stream())
        torch.cuda.synchronize()
        runs.append((net, time.perf_counter() - t))
    with tempfile.TemporaryDirectory() as td:
        ck = f"{td}/ck"
        first = fresh()
        first.set_listeners([SigtermAfter(CKPT_STOP)])
        try:
            first.fit(stream(), checkpoint_dir=ck,
                      checkpoint_every_n_batches=2)
            interrupted = False
        except TrainingInterrupted:
            interrupted = True
        resumed = fresh()
        t = time.perf_counter()
        resumed.fit(stream(), checkpoint_dir=ck,
                    checkpoint_every_n_batches=2)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t
    launches = kernels.LAUNCHES["lstm_cell"]
    ref, other = runs[0][0], runs[1][0]
    spread = params_gap(torch, other, ref)
    gap = params_gap(torch, resumed, ref)
    row = {"phase": "checkpoint", "config": LSTM, "batches": CKPT_BATCHES,
           "sigterm_after": CKPT_STOP, "interrupted": interrupted,
           "resumed_from_batch": resumed.resumed_from_batch,
           "resumed_steps": resumed.step_cache.stats.steps,
           "checkpoints_written": [first.checkpoints_written,
                                   resumed.checkpoints_written],
           "checkpoint_write_s": [first.checkpoint_write_seconds,
                                  resumed.checkpoint_write_seconds],
           "uninterrupted_fit_s": [s for _, s in runs],
           "resumed_fit_s": resumed_s,
           "uninterrupted_vs_uninterrupted": spread,
           "resumed_vs_uninterrupted": gap, "launches": launches}
    emit(row)
    check(interrupted, "SIGTERM did not interrupt the checkpointed fit")
    check(resumed.resumed_from_batch == CKPT_STOP
          and resumed.step_cache.stats.steps == CKPT_BATCHES - CKPT_STOP,
          f"the rerun did not resume at batch {CKPT_STOP}: {row}")
    check(gap["max_abs_diff"] <= spread["max_abs_diff"],
          f"the resumed run differs from an uninterrupted one by more than "
          f"two uninterrupted runs differ: {gap} vs {spread}")
    return launches


#: the CLI's generate on the lstm_cli checkpoint: a prompt of 20 ids, 64
#: new tokens, a 128-token table; then again with the ported options
CLI_GEN = dict(prompt=20, new=64, max_seq=128)
CLI_GEN_OPTIONS = ["--steps-per-dispatch", "4", "--page-size", "16",
                   "--prefix-cache"]
#: speculative decoding from the CLI (the draft's checkpoint follows)
CLI_GEN_DRAFT = ["--spec-k", "3", "--draft"]


def cli_generate_direct(torch, ckpt, prompt, temperature):
    """The tokens of the cached path called directly on the checkpoint's
    network (B = 1 prefill into the bucket the CLI picks, then one decode
    a token, key from seed 5): what the CLI's one-slot batcher must give."""
    from deeplearning4j_tpu_torch.nd import random as nd_random
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    net = load_network(ckpt)
    ic = net.infer_cache
    n = len(prompt)
    pb = np.zeros((1, max(4, 1 << (n - 1).bit_length())), np.int32)
    pb[0, :n] = prompt
    state = ic.init_decode_state(net.conf, 1, CLI_GEN["max_seq"], "cuda")
    temps = np.full((1,), temperature, np.float32)
    tok, keys, state = ic.prefill(net.conf, net.params, state, pb,
                                  np.asarray([n], np.int32),
                                  nd_random.prng_key(5, "cuda")[None], temps)
    out, pos = [int(tok[0])], np.asarray([n], np.int32)
    for _ in range(CLI_GEN["new"] - 1):
        tok, keys, state = ic.decode(net.conf, net.params, state, tok, pos,
                                     keys, temps)
        out.append(int(tok[0]))
        pos = pos + 1
    return out


def phase_lstm_cli(torch, kernels):
    """The CLI north star in process: `train` over the word corpus with
    bench.py:1716-1719's arguments, then `predict` and `test` on the
    checkpoint. Checks the JSON lines, that each command launched the cell
    kernel, and that predict's probabilities equal a direct `net.output`
    on the loaded checkpoint. Returns the launches of the three commands."""
    import contextlib
    import io
    import tempfile

    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.cli.schemes import load_input
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    def run(argv):
        buf = io.StringIO()
        before = kernels.LAUNCHES["lstm_cell"]
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(rc == 0, f"cli {argv[0]} exited {rc}")
        last = json.loads(buf.getvalue().strip().splitlines()[-1])
        return last, kernels.LAUNCHES["lstm_cell"] - before, wall

    with tempfile.TemporaryDirectory() as td:
        with open(f"{td}/corpus.txt", "w") as f:
            f.write(word_corpus())
        uri = f"text:{td}/corpus.txt:{CLI_SEQ}"
        ckpt, csv_path = f"{td}/lstm4", f"{td}/pred.csv"
        kernels.reset_launches()
        train, l_train, w_train = run(
            ["train", "--input", uri, "--zoo",
             "char_lstm:layers=4,hidden=128", "--output", ckpt,
             "--properties", "epochs=1"])
        # the crash-safe form: batches of 256 windows, a checkpoint every
        # 4 of them and at the end
        ck_train, l_ck, w_ck = run(
            ["train", "--input", uri, "--zoo",
             "char_lstm:layers=4,hidden=128", "--output", f"{td}/lstm4ck",
             "--properties", "epochs=1,batch=256,checkpoint_every=4",
             "--checkpoint-dir", f"{td}/ck"])
        with open(f"{td}/ck/meta.json") as f:
            ck_cursor = json.load(f)["data_cursor"]
        pred, l_pred, w_pred = run(["predict", "--input", uri, "--model",
                                    ckpt, "--output", csv_path])
        test, l_test, w_test = run(["test", "--input", uri, "--model",
                                    ckpt])
        launches = kernels.LAUNCHES["lstm_cell"]
        data = load_input(uri)
        # generation from the same checkpoint, greedy and at 0.8; the
        # tokens must be those of the cached path called directly
        gen_prompt = np.random.RandomState(8).randint(
            0, int(data.vocab_size), CLI_GEN["prompt"]).tolist()
        generated = {}
        gen_argv = ["generate", "--model", ckpt, "--prompt",
                    ",".join(map(str, gen_prompt)), "--max-new-tokens",
                    str(CLI_GEN["new"]), "--max-seq",
                    str(CLI_GEN["max_seq"]), "--seed", "5"]
        for temp in ("0", "0.8"):
            line, _, wall = run(gen_argv + ["--temperature", temp])
            generated[temp] = dict(line, wall_s=wall,
                                   direct=cli_generate_direct(
                                       torch, ckpt, gen_prompt, float(temp)))
            # the ported options: the same tokens
            line, _, wall = run(gen_argv + ["--temperature", temp]
                                + CLI_GEN_OPTIONS)
            generated[temp]["with_options"] = dict(line, wall_s=wall)
            # speculative, the checkpoint its own draft: the same tokens
            line, _, wall = run(gen_argv + ["--temperature", temp]
                                + CLI_GEN_DRAFT + [ckpt])
            generated[temp]["with_draft"] = dict(line, wall_s=wall)
        net = load_network(ckpt)
        direct = net.output(data.features).float().cpu().numpy()
        probs = np.loadtxt(csv_path, delimiter=",", skiprows=1,
                           dtype=np.float64)[:, 1:]
    err = float(np.abs(probs - direct).max())
    n_win = data.num_examples()
    row = {"phase": "lstm_cli", "windows": n_win, "seq": CLI_SEQ,
           "vocab": int(data.vocab_size), "train": train,
           "chars_per_s": train["examples_per_sec"] * CLI_SEQ,
           "train_checkpointed": ck_train, "checkpoint_cursor": ck_cursor,
           "predict": pred, "test": test,
           "launches": {"train": l_train, "train_checkpointed": l_ck,
                        "predict": l_pred, "test": l_test},
           "wall_s": {"train": w_train, "train_checkpointed": w_ck,
                      "predict": w_pred, "test": w_test},
           "predict_vs_direct_max_abs_err": err,
           "generate": {t: {k: v for k, v in g.items() if k != "direct"}
                        for t, g in generated.items()}}
    emit(row)
    # the JAX package's generate line (deeplearning4j_tpu/cli/driver.py:
    # 642-649)
    for temp, line in generated.items():
        opt = line.pop("with_options")
        check(opt["tokens"] == line["tokens"] and opt["fresh_compiles"] == 0,
              f"generate {' '.join(CLI_GEN_OPTIONS)} at temperature {temp}: "
              f"{opt} vs {line['tokens']}")
        spec = line.pop("with_draft")
        check(spec["tokens"] == line["tokens"]
              and spec["fresh_compiles"] == 0,
              f"generate {' '.join(CLI_GEN_DRAFT)} at temperature {temp}: "
              f"{spec} vs {line['tokens']}")
        check(set(line) - {"wall_s", "direct"}
              == {"tokens", "n_tokens", "tokens_per_sec", "ttft_ms",
                  "fresh_compiles", "disk_cache"}
              and line["n_tokens"] == CLI_GEN["new"]
              and line["fresh_compiles"] == 0
              and line["tokens"] == line["direct"],
              f"generate line at temperature {temp}: {line}")
    # the JAX package's train line (deeplearning4j_tpu/cli/driver.py:350-365)
    train_keys = {"saved", "score", "resumed_from_step",
                  "checkpoint_write_seconds", "train_seconds",
                  "examples_per_sec", "compile_seconds", "cache_hits",
                  "cache_misses", "infer_compile_seconds", "disk_cache"}
    for line in (train, ck_train):
        check(set(line) == train_keys and np.isfinite(line["score"]),
              f"train line {line}")
    n_batches = -(-n_win // 256)
    check(ck_cursor == {"batches_done": n_batches}
          and ck_train["checkpoint_write_seconds"] > 0
          and ck_train["cache_hits"] == n_batches - ck_train["cache_misses"],
          f"checkpointed train line {ck_train}, cursor {ck_cursor}")
    check(pred["n"] == n_win * CLI_SEQ, f"predict line {pred}")
    check(set(test) == {"accuracy", "f1", "disk_cache"}
          and 0.0 <= test["accuracy"] <= 1.0, f"test line {test}")
    check(min(l_train, l_ck, l_pred, l_test) > 0,
          f"a command never launched the cell kernel: {row['launches']}")
    check(probs.shape == direct.shape and err <= 2e-6,
          f"predict differs from net.output by {err}")
    return launches


# ---------------------------------------------------------------- word2vec

#: the bench's Word2Vec (bench.py:368-385, nothing cut): vocab 10,000, 1.2M
#: zipf tokens in sentences of 20, vector 128, window 5, negative 5,
#: hierarchical softmax on, batch 32,768, 6 epochs, seed 0
W2V = dict(vocab=10_000, tokens=1_200_000, sent_len=20, vector=128, window=5,
           negative=5, batch=32_768, epochs=3, seed=0)
#: gathers (so scatter-add launches) per step: syn0, syn1 and syn1neg (the
#: contexts and negatives in one gather); GloVe: w, wt, b, bt
W2V_GATHERS, GLOVE_GATHERS = 3, 4


def bench_sentences():
    """The bench's corpus, made as bench.py:368-381 makes it: 60,000
    sentences of 20 zipf-drawn words w0..w9999."""
    rng = np.random.RandomState(0)
    v, n, sl = W2V["vocab"], W2V["tokens"], W2V["sent_len"]
    freq = 1.0 / np.arange(1, v + 1)
    tokens = rng.choice(v, size=n, p=freq / freq.sum())
    words = np.array([f"w{i}" for i in range(v)])
    return [list(words[tokens[i:i + sl]]) for i in range(0, n, sl)]


def bench_word2vec(**overrides):
    """The bench's Word2Vec (bench.py:383-385) on the card, with
    `overrides` of its keyword arguments."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec

    kw = dict(vector_length=W2V["vector"], window=W2V["window"],
              negative=W2V["negative"], min_word_frequency=1,
              epochs=W2V["epochs"], seed=W2V["seed"],
              batch_size=W2V["batch"], device="cuda")
    return Word2Vec(**{**kw, **overrides})


def w2v_fixed_batch(torch, sents):
    """A model with the bench's vocabulary (built as `fit` builds it, so its
    fresh tables equal the tables `fit` starts from) and one fixed batch of
    the bench's shape on the card: the first W2V["batch"] pairs of a pair
    draw from another seed, and negatives from the unigram table. Returns
    (model, centers, contexts, neg, vocab arrays)."""
    from deeplearning4j_tpu_torch.text.corpus import TokenCorpus

    model = bench_word2vec()
    toks = TokenCorpus(sents, model.tokenize)
    model.build_vocab(toks)
    model._rng = np.random.RandomState(1)
    ids = [np.asarray([model.cache.index_of(t) for t in s], np.int32)
           for s in toks]
    centers, contexts = model._pairs(ids)
    pick = np.random.RandomState(2).permutation(len(centers))[:W2V["batch"]]
    vocab = model._vocab_arrays()
    gen = torch.Generator(device="cuda").manual_seed(3)
    slots = torch.randint(0, vocab[3].shape[0],
                          (W2V["batch"], W2V["negative"]), generator=gen,
                          device="cuda")
    c = torch.as_tensor(centers[pick], device="cuda")
    x = torch.as_tensor(contexts[pick], device="cuda")
    return model, c, x, vocab[3][slots], vocab


def w2v_batch_loss(torch, tables, centers, contexts, neg, vocab) -> float:
    """The port's loss function on the fixed batch, per pair."""
    from deeplearning4j_tpu_torch.models.word2vec import w2v_loss

    codes, points, mask, _ = vocab
    with torch.no_grad():
        loss = w2v_loss(tables["syn0"], tables["syn1"], tables["syn1neg"],
                        centers, contexts, codes[contexts], points[contexts],
                        mask[contexts], neg)
    return loss.item() / centers.shape[0]


def scatter_bound_ms(torch, table, idx, upd):
    """max(bytes / HBM rate, adds / f32 rate) for one scatter-add: the
    updates and indices read once, each table row this input touches read
    and written once; one add per update element. Returns (ms, bound_by,
    touched rows)."""
    rows = table.shape[0]
    touched = torch.unique(idx[(idx >= 0) & (idx < rows)]).numel()
    width = upd.numel() // max(1, upd.shape[0])
    size = table.element_size()
    nbytes = (upd.numel() * size + idx.numel() * idx.element_size()
              + 2 * touched * width * size)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = upd.numel() / PEAK_FLOPS["float32"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", touched)


def scatter_close(torch, kernels, table, idx, upd, got, want):
    """(max |got - want|, ok) where ok holds |got - want| <= 2 n u S element
    by element: S = |table| + the sum of |upd| over the row's updates, n the
    row's adds plus one, u the dtype's unit roundoff. That is the error
    bound of a sum taken in any order, for the kernel (whose atomics add in
    an order that changes from run to run) and its plain version together."""
    u = 2.0 ** -24 if table.dtype == torch.float32 else 2.0 ** -8
    rows = table.shape[0]
    s = kernels.scatter_add_rows_reference(table.abs().float(), idx,
                                           upd.abs().float())
    n = torch.bincount(idx[(idx >= 0) & (idx < rows)].long(),
                       minlength=rows).float() + 1
    if table.dim() == 2:
        n = n[:, None]
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= 2 * n * u * s).all())


def d1_ragged_cases(torch):
    """Scatter cases for the one-thread-per-update body (D = 1): 1,001
    updates (not a whole number of warps) into 7 rows from indices in
    [-2, 9), so each warp holds several updates of every row and indices
    outside the table on both sides; as a 1-D bias and as an [R, 1] table."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    idx = torch.randint(-2, 9, (1001,), generator=gen, device="cuda")
    return [("ragged_d1", 7, 0, idx, torch.float32),
            ("ragged_d1_2d", 7, 1, idx.to(torch.int32), torch.float32)]


def draw_table(torch, gen, shape, integer, dt=None):
    """A table or updates on the card (float32, or `dt`): integers in
    [-4, 4] (any order of adds is exact) or standard normal values."""
    if integer:
        out = torch.randint(-4, 5, shape, generator=gen, device="cuda")
    else:
        out = torch.randn(shape, generator=gen, device="cuda")
    return out.to(dt or torch.float32)


def scatter_check(torch, kernels, gen, r, width, idx, dt):
    """The scatter kernel against its plain version on a table [r, width]
    ([r] when width is 0) and updates at idx: integer-valued inputs (any
    order of adds is exact) must give equal tables; random ones are held to
    `scatter_close`. Returns (exact, max |got - want|, close, tensors):
    the integer table and updates, the random ones, the kernel's and the
    plain version's results on them (kept alive by the caller while it
    times, so that the timed tables land where they always have)."""
    shape = (r, width) if width else (r,)
    ushape = (idx.shape[0], width) if width else (idx.shape[0],)
    ti, ui = (draw_table(torch, gen, sh, True, dt) for sh in (shape, ushape))
    exact = torch.equal(kernels.scatter_add_rows(ti, idx, ui),
                        kernels.scatter_add_rows_reference(ti, idx, ui))
    table, upd = (draw_table(torch, gen, sh, False, dt)
                  for sh in (shape, ushape))
    got = kernels.scatter_add_rows(table, idx, upd)
    want = kernels.scatter_add_rows_reference(table, idx, upd)
    torch.cuda.synchronize()
    err, close = scatter_close(torch, kernels, table, idx, upd, got, want)
    return exact, err, close, (ti, ui, table, upd, got, want)


def phase_scatter_kernel(torch, kernels, centers, contexts, neg, points):
    """The scatter-add kernel against its plain version on the card at the
    word2vec step's shapes (indices from the bench's vocabulary and a batch
    of its pairs): syn1 (the pairs' Huffman points, 622,592 rows into 9,999,
    the root on every path), syn0 (32,768 centers), syn1neg (contexts and
    negatives, 196,608 rows); a GloVe bias (D = 1), a tiny ragged case with
    duplicates and out-of-range indices, bf16, the ragged D = 1 cases
    of `d1_ragged_cases`, every update of syn1's shape into one row
    ("hot_row"), syn1's shape with uniform indices, and a ragged D = 30
    with indices outside the table. Each twice: integer-valued
    inputs, where any order of adds is exact, must give equal tables; random
    inputs are held to `scatter_close` and timed (graph replay) beside the
    plain version, `index_add_` and the bound. Returns {case: row}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    vocab_n = W2V["vocab"]
    d = W2V["vector"]
    ragged_idx = torch.tensor([3, 0, 3, -1, 7, 6, 3, 99, 0, 2, 3, 6, 1],
                              device="cuda")
    cases = [
        ("syn1", vocab_n - 1, d, points[contexts].reshape(-1), torch.float32),
        ("syn0", vocab_n, d, centers, torch.float32),
        ("syn1neg", vocab_n, d,
         torch.cat([contexts[:, None], neg], 1).reshape(-1), torch.float32),
        ("glove_bias", vocab_n, 0, centers, torch.float32),
        ("ragged", 7, 5, ragged_idx, torch.float32),
        ("bf16", vocab_n, d,
         torch.randint(0, vocab_n, (W2V["batch"],), generator=gen,
                       device="cuda", dtype=torch.int32), torch.bfloat16)]
    cases += d1_ragged_cases(torch)
    syn1_n = cases[0][3].shape[0]
    cases += [
        # every update of syn1's shape into one row: the hottest index
        ("hot_row", vocab_n - 1, d,
         torch.zeros(syn1_n, dtype=torch.int64, device="cuda"),
         torch.float32),
        # syn1's shape with indices drawn uniformly: few duplicates
        ("uniform", vocab_n - 1, d,
         torch.randint(0, vocab_n - 1, (syn1_n,), generator=gen,
                       device="cuda"), torch.float32),
        # a D that takes single-float columns, indices outside the table
        ("ragged_d", 1000, 30,
         torch.randint(-2, 1002, (50_000,), generator=gen, device="cuda"),
         torch.float32)]
    ptxas = [line.strip() for line in
             kernels.BUILD_LOGS.get("scatter_add", "").splitlines()
             if "registers" in line or "spill" in line]
    rows = {}
    for name, r, width, idx, dt in cases:
        exact, err, close, (ti, ui, table, upd, got, want) = scatter_check(
            torch, kernels, gen, r, width, idx, dt)
        in_range = bool(((idx >= 0) & (idx < r)).all())
        scratch = table.clone()
        bound_ms, bound_by, touched = scatter_bound_ms(torch, table, idx, upd)
        row = {"phase": "scatter_kernel", "case": name, "rows": r,
               "width": width or 1, "n": int(idx.shape[0]),
               "index_dtype": str(idx.dtype).replace("torch.", ""),
               "dtype": str(dt).replace("torch.", ""),
               "touched_rows": touched,
               "max_dup": int(torch.bincount(
                   idx[(idx >= 0) & (idx < r)].long()).max().item()),
               "exact_on_integers": exact, "max_abs_err": err,
               "max_abs_want": want.float().abs().max().item(),
               "within_sum_bound": close, "ok": exact and close,
               "kernel_ms": graph_ms(lambda: kernels.scatter_add_rows_(
                   scratch, idx, upd)),
               "call_ms": cuda_ms(lambda: kernels.scatter_add_rows_(
                   scratch, idx, upd)),
               "plain_ms": graph_ms(lambda: kernels.scatter_add_rows_reference(
                   table, idx, upd), iters=5 if touched > 1 else 1,
                   replays=1),
               # index_add_ asserts on the device at an out-of-range index
               "library_ms": (graph_ms(lambda: scratch.index_add_(0, idx, upd))
                              if in_range else None),
               "bound_ms": bound_ms, "bound_by": bound_by, "ptxas": ptxas}
        emit(row)
        check(row["ok"], f"scatter_add_rows disagrees with its plain "
                         f"version: {row}")
        rows[name] = row
        del ti, ui, table, upd, got, want, scratch
    torch.cuda.empty_cache()
    return rows


def sorted_body_cases(torch):
    """Scatter cases for the f32 D > 1 body's first check: (name, R, D,
    indices) with zipf indices (the head takes most updates, as in the
    word2vec tables) at 32,768, 196,608 and 622,592 updates (on an H100 the
    launch rule gives them chunks of 256, 512 and 1,024), every update in
    one row, uniform indices, D = 30 (single-float columns) with indices
    outside the table on both sides, D = 100 with int64 indices, and 13
    updates (less than one chunk)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = 100_000
    cases = []
    for zn in (32_768, 196_608, 622_592):
        zipf = np.minimum(np.random.RandomState(7).zipf(1.2, zn) - 1, 9998)
        cases.append((f"zipf_{zn}", 9999, 128,
                      torch.as_tensor(zipf.astype(np.int32), device="cuda")))
    return cases + [
        ("hot_row", 9999, 128,
         torch.full((n,), 3, dtype=torch.int32, device="cuda")),
        ("uniform", 9999, 128,
         torch.randint(0, 9999, (n,), generator=gen, device="cuda",
                       dtype=torch.int32)),
        ("ragged_d", 1000, 30,
         torch.randint(-2, 1002, (n // 2,), generator=gen, device="cuda")),
        ("d100_int64", 500, 100,
         torch.randint(0, 500, (n // 4,), generator=gen, device="cuda")),
        ("tiny", 7, 6,
         torch.tensor([3, 0, 3, -1, 7, 6, 3, 99, 0, 2, 3, 6, 1],
                      device="cuda"))]


def count_calls(module, name, events=None):
    """Wrap module.name so that each call is counted (and, with `events`, is
    bracketed by CUDA events appended there); returns (counter, restore)."""
    import torch

    real = getattr(module, name)
    counter = {"calls": 0}

    def wrapped(*a, **kw):
        counter["calls"] += 1
        if events is None:
            return real(*a, **kw)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        stop.record()
        events.append((start, stop))
        return out

    setattr(module, name, wrapped)
    return counter, lambda: setattr(module, name, real)


def profile_w2v_steps(torch, kernels, model, batch, steps=3):
    """`steps` more word2vec steps on the fixed batch under `torch.profiler`
    (alpha at min_alpha): device time by kernel, the scatter kernel's share,
    idle share. Launches made here are not counted as the main path's."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.word2vec import SYN_KEYS

    centers, contexts, neg, vocab = batch
    tables = {k: getattr(model.table, k) for k in SYN_KEYS}
    gen = torch.Generator(device="cuda").manual_seed(5)
    saved = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            model._batch_step(tables, gen, centers, contexts, vocab,
                              model.min_alpha)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels.LAUNCHES.update(saved)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    total_us = sum(e.device_time_total for e in events)
    ours = [e for e in events if "scatter_add" in e.key]
    row = {"phase": "w2v_train_profile", "steps": steps,
           "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": total_us / 1e3 / steps,
           "idle_share": 1.0 - total_us / 1e3 / wall_ms,
           "scatter_kernel_ms_per_step":
               sum(e.device_time_total for e in ours) / 1e3 / steps,
           "kernels_per_step": sum(e.count for e in events) / steps,
           "top": [{"name": e.key[:90], "calls": e.count,
                    "ms": e.device_time_total / 1e3} for e in events[:15]]}
    emit(row)
    return row


def w2v_fit_run(torch, kernels, sents, fixed, phase, **overrides):
    """One timed `Word2Vec.fit` of the bench's configuration (with
    `overrides`): words/s as bench.py:391 computes it (tokens x epochs /
    wall, the vocab build included, a device sync at the end), the step
    time (CUDA events around each step, median), the host's pair draws, the
    scatter launches (W2V_GATHERS a step), the fixed batch's loss per pair
    before and after, and whether the tables are finite. Emits and returns
    the row and the trained model."""
    import deeplearning4j_tpu_torch.models.word2vec as w2v_mod

    probe, centers, contexts, neg, vocab = fixed
    before = w2v_batch_loss(torch, {k: getattr(probe.table, k)
                                    for k in w2v_mod.SYN_KEYS},
                            centers, contexts, neg, vocab)
    model = bench_word2vec(**overrides)
    pair_s = []
    real_pairs = model._pairs

    def timed_pairs(ids):
        t = time.perf_counter()
        out = real_pairs(ids)
        pair_s.append(time.perf_counter() - t)
        return out

    model._pairs = timed_pairs
    events = []
    counter, restore = count_calls(w2v_mod, "w2v_step", events)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        model.fit(sents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = kernels.LAUNCHES["scatter_add_rows"]
    steps = counter["calls"]
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    tables = {k: getattr(model.table, k) for k in w2v_mod.SYN_KEYS}
    after = w2v_batch_loss(torch, tables, centers, contexts, neg, vocab)
    row = {"phase": phase, "config": {**W2V, "epochs": model.epochs},
           "use_adagrad": model.use_adagrad, "steps": steps,
           "fit_wall_s": wall,
           "words_per_s": W2V["tokens"] * model.epochs / wall,
           "step_ms_median": step_ms[len(step_ms) // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "steps_wall_s": sum(step_ms) / 1e3,
           "pairs_host_s": pair_s,
           "launches": launches, "launches_per_step": launches / max(1, steps),
           "fixed_batch_loss_per_pair": [before, after],
           "tables_finite": all(bool(torch.isfinite(t).all())
                                for t in tables.values()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    check(steps >= model.epochs, f"fit took {steps} steps")
    check(launches == W2V_GATHERS * steps,
          f"scatter_add_rows launched {launches} times in {steps} steps, "
          f"want {W2V_GATHERS} a step")
    return row, model


def phase_w2v_train(torch, kernels, sents, fixed):
    """The bench's Word2Vec trained at full size, nothing cut: SGD with
    alpha 0.025 decaying, 6 epochs (`w2v_fit_run`), then profiled steps.
    That configuration's summed-batch SGD diverges in the JAX package too
    (ROADMAP queue C): its tables are recorded, and must be finite with a
    falling loss only if they stay finite. Then the same widths, batch and
    corpus with the reference's per-word AdaGrad (alpha 0.025 fixed) for one
    epoch, whose tables must stay finite and whose fixed-batch loss must
    fall. Returns the launches of both fits and the first row."""
    _, centers, contexts, neg, vocab = fixed
    row, model = w2v_fit_run(torch, kernels, sents, fixed, "w2v_train")
    if row["tables_finite"]:
        before, after = row["fixed_batch_loss_per_pair"]
        check(after < before, f"the fixed batch's loss did not fall: "
                              f"{before} -> {after}")
    row["profile"] = profile_w2v_steps(torch, kernels, model,
                                       (centers, contexts, neg, vocab))
    del model
    torch.cuda.empty_cache()
    ada, model = w2v_fit_run(torch, kernels, sents, fixed,
                             "w2v_train_adagrad", use_adagrad=True, epochs=1)
    before, after = ada["fixed_batch_loss_per_pair"]
    check(ada["tables_finite"], "an AdaGrad word2vec table is not finite")
    check(after < before, f"the fixed batch's loss did not fall under "
                          f"AdaGrad: {before} -> {after}")
    del model
    torch.cuda.empty_cache()
    return row["launches"] + ada["launches"], row


def cluster_corpus(n=200, seed=0):
    """tests/test_embeddings.py:18-28: sentences of 8 words from one of two
    topic clusters, {cat, dog, pet, fur, paw} or {car, truck, road, wheel,
    engine}."""
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    out = []
    for _ in range(n):
        pool = animals if rng.rand() < 0.5 else vehicles
        out.append(" ".join(rng.choice(pool, size=8)))
    return out


def phase_embed_quality(torch, kernels):
    """Word2Vec, ParagraphVectors and GloVe trained on the card on the
    two-cluster corpus with the settings of tests/test_embeddings.py, held
    to its similarity assertions; each must launch the scatter kernel once
    per gather of every step. Returns {model: launches}."""
    import deeplearning4j_tpu_torch.models.glove as glove_mod
    import deeplearning4j_tpu_torch.models.word2vec as w2v_mod
    from deeplearning4j_tpu_torch.models import (Glove, ParagraphVectors,
                                                 Word2Vec)

    def run(make, module, name, gathers):
        counter, restore = count_calls(module, name)
        kernels.reset_launches()
        try:
            t = time.perf_counter()
            model = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            restore()
        launches = kernels.LAUNCHES["scatter_add_rows"]
        check(counter["calls"] > 0 and launches == gathers * counter["calls"],
              f"{name}: {launches} scatter launches in {counter['calls']} "
              f"steps, want {gathers} a step")
        return model, {"steps": counter["calls"], "launches": launches,
                       "wall_s": wall}

    w2v, w2v_info = run(lambda: Word2Vec(
        vector_length=24, window=4, min_word_frequency=1, negative=4,
        epochs=4, batch_size=256, seed=1).fit(cluster_corpus()),
        w2v_mod, "w2v_step", W2V_GATHERS)
    same, cross = w2v.similarity("cat", "dog"), w2v.similarity("cat", "truck")
    near = [w for w, _ in w2v.words_nearest("cat", top=4)]
    docs = ["cat dog pet fur paw cat dog", "car truck road wheel engine",
            "dog pet paw fur cat pet", "truck car engine wheel road"]
    pv, pv_info = run(lambda: ParagraphVectors(
        vector_length=16, window=3, min_word_frequency=1, negative=3,
        epochs=8, batch_size=64, seed=4,
        labels=["an1", "ve1", "an2", "ve2"]).fit(docs),
        w2v_mod, "w2v_step", W2V_GATHERS)
    glove, glove_info = run(lambda: Glove(
        vector_length=16, window=5, min_word_frequency=1, epochs=20,
        seed=1).fit(cluster_corpus(150)), glove_mod, "glove_step",
        GLOVE_GATHERS)
    checks = {
        "w2v_same_gt_cross": [same, cross],
        "w2v_nearest_cat": near,
        "pv_an1_an2_gt_an1_ve1": [pv.doc_similarity("an1", "an2"),
                                  pv.doc_similarity("an1", "ve1")],
        "glove_cat_dog_gt_cat_engine": [glove.similarity("cat", "dog"),
                                        glove.similarity("cat", "engine")]}
    row = {"phase": "embed_quality", "word2vec": w2v_info,
           "paragraph_vectors": pv_info, "glove": glove_info,
           "checks": checks}
    emit(row)
    check(same > cross, f"word2vec: cat~dog {same} <= cat~truck {cross}")
    check(any(w in ("dog", "pet", "fur", "paw") for w in near),
          f"word2vec: nearest to cat {near}")
    a, b = checks["pv_an1_an2_gt_an1_ve1"]
    check(a > b, f"paragraph vectors: an1~an2 {a} <= an1~ve1 {b}")
    a, b = checks["glove_cat_dog_gt_cat_engine"]
    check(a > b, f"glove: cat~dog {a} <= cat~engine {b}")
    return {"word2vec": w2v_info["launches"],
            "paragraph_vectors": pv_info["launches"],
            "glove": glove_info["launches"]}


# ------------------------------------------------- datasets, serving, API

#: the datasets_serve_api phase: bench.py:416's 784-512-512-10 MLP on the
#: 60,000-image MNIST stand-in (bench.py:413's batch of 8,192) through the
#: CLI; Iris through a `list_builder` net (SGD); the SLICE charTransformer
#: served batched and unbatched to REQUESTS_API requests of 2 rows (mixed
#: priorities, buckets 2 and 8 warmed), then by the CLI's `serve --shapes`
#: in a subprocess; a CheckpointListener's asynchronous saves during
#: captured `fit` steps at SLICE's width (depth cut to API_TRAIN_BLOCKS, rows
#: to API_TRAIN_ROWS: each save writes every param to disk)
MNIST_N, MLP_BATCH, MLP_EPOCHS = 60000, 8192, 5
MLP_MIN_ACCURACY = 0.5  # chance (0.1) + 0.4
IRIS_ITERS, IRIS_MIN_ACCURACY = 100, 0.9
REQUESTS_API = 4
API_TRAIN_BLOCKS, API_TRAIN_ROWS, API_TRAIN_STEPS = 2, 4, 3


def write_idx(path, arr):
    """An uncompressed u8 IDX file of `arr`."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(np.ascontiguousarray(arr, np.uint8).tobytes())


def cli_json(cli_main, argv):
    """Run the port's CLI in process; (exit code, its last JSON line)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def api_mnist_cli(torch, td):
    """(a): the stand-in written as IDX, read natively and in Python, then
    `train --zoo mlp:hidden=512x512 --input mnist:60000` and `test` through
    the CLI with MNIST_DIR there, so the CLI reads it natively."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.datasets import mnist as mnist_mod

    X, y = mnist_mod.synthetic_mnist(MNIST_N)
    d = os.path.join(td, "mnist")
    os.makedirs(d)
    images = np.round(X.reshape(-1, 28, 28) * 255).astype(np.uint8)
    write_idx(os.path.join(d, "train-images-idx3-ubyte"), images)
    write_idx(os.path.join(d, "train-labels-idx1-ubyte"), y.astype(np.uint8))
    t = time.perf_counter()
    lib = native.get_library()
    build_s = time.perf_counter() - t
    check(lib is not None, "the native IDX/CSV reader did not build")
    path = os.path.join(d, "train-images-idx3-ubyte")
    times = {"native": [], "python": []}
    for _ in range(3):
        t = time.perf_counter()
        via_native = native.native_read_idx(path)
        times["native"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        via_python = mnist_mod.read_idx_python(path)
        times["python"].append((time.perf_counter() - t) * 1e3)
    check(via_native is not None and np.array_equal(via_native, via_python)
          and np.array_equal(via_native, images),
          "the native and Python IDX readers disagree")
    # every IDX read of the CLI, and whether the native reader answered it
    reads, real_read = [], native.native_read_idx

    def counted(p):
        arr = real_read(p)
        reads.append(arr is not None)
        return arr

    native.native_read_idx = counted
    old_dir = os.environ.get("MNIST_DIR")
    os.environ["MNIST_DIR"] = d
    ckpt = os.path.join(td, "mlp")
    try:
        rc, train = cli_json(cli_main, [
            "train", "--input", f"mnist:{MNIST_N}", "--zoo",
            "mlp:hidden=512x512", "--output", ckpt, "--properties",
            f"epochs={MLP_EPOCHS},batch={MLP_BATCH}"])
        check(rc == 0, f"cli train exited {rc}")
        rc, test = cli_json(cli_main, ["test", "--input", f"mnist:{MNIST_N}",
                                       "--model", ckpt])
        check(rc == 0, f"cli test exited {rc}")
    finally:
        native.native_read_idx = real_read
        if old_dir is None:
            os.environ.pop("MNIST_DIR")
        else:
            os.environ["MNIST_DIR"] = old_dir
    steps = MLP_EPOCHS * -(-MNIST_N // MLP_BATCH)
    row = {"native_build_s": build_s, "native_read_ms": times["native"],
           "python_read_ms": times["python"],
           "idx_bytes": os.path.getsize(path),
           "native_reads_in_cli": sum(reads), "train": train,
           "steps": steps,
           "step_ms": (train["train_seconds"] - train["compile_seconds"])
           * 1e3 / steps,
           "accuracy": test["accuracy"], "f1": test["f1"]}
    check(len(reads) >= 4 and all(reads),
          f"the CLI did not read MNIST natively: {reads}")
    check(np.isfinite(train["score"]), f"MLP score is not finite: {row}")
    check(test["accuracy"] >= MLP_MIN_ACCURACY,
          f"MLP accuracy {test['accuracy']} is not chance + 0.4: {row}")
    return row


def api_prefetch_pull(torch, consumers: int = 2) -> dict:
    """A `PrefetchIterator` over the MNIST stand-in's batches (4,096 rows
    of 784 a batch, with the batch's index beside it) to the card, started
    once and pulled from `consumers` threads: each batch must reach exactly
    one of them, its features equal to the host's."""
    from deeplearning4j_tpu_torch.datasets import mnist as mnist_mod
    from deeplearning4j_tpu_torch.datasets.iterator import PrefetchIterator

    X, _ = mnist_mod.synthetic_mnist(MNIST_N)
    X = X.astype(np.float32)
    bsz = 4096
    host = [X[i:i + bsz] for i in range(0, len(X), bsz)]
    it = PrefetchIterator([(x, np.full((1,), i, np.int64))
                           for i, x in enumerate(host)], device="cuda")
    got = {c: [] for c in range(consumers)}
    equal, errors = [], []

    def consume(c):
        try:
            while True:
                feats, idx = it.pull()
                i = int(idx.item())
                got[c].append(i)
                equal.append(bool(np.array_equal(feats.cpu().numpy(),
                                                 host[i])))
        except StopIteration:
            return
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    it.start()
    threads = [threading.Thread(target=consume, args=(c,))
               for c in range(consumers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    it.close()
    seconds = time.perf_counter() - t0
    delivered = sorted(i for v in got.values() for i in v)
    row = {"batches": len(host), "rows_per_batch": bsz,
           "consumers": consumers,
           "by_consumer": {str(c): len(v) for c, v in got.items()},
           "delivered_once": delivered == list(range(len(host))),
           "copies_equal": bool(equal) and all(equal), "errors": errors,
           "seconds": seconds}
    check(not errors and not any(t.is_alive() for t in threads)
          and row["delivered_once"] and row["copies_equal"],
          f"the prefetcher's pull from {consumers} threads: {row}")
    return row


def api_iris_cifar(torch):
    """(b): `iris:` and `cifar10:` through load_input; an Iris net built with
    `list_builder`, trained by SGD on the card."""
    from deeplearning4j_tpu_torch.cli.schemes import load_input
    from deeplearning4j_tpu_torch.evaluation import Evaluation
    from deeplearning4j_tpu_torch.nd.losses import LossFunction
    from deeplearning4j_tpu_torch.nn.conf import (LayerType,
                                                  NeuralNetConfiguration,
                                                  OptimizationAlgorithm,
                                                  list_builder)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    iris = load_input("iris:150")
    cifar = load_input("cifar10:10000")
    check(iris.features.shape == (150, 4) and iris.labels.shape == (150, 3),
          f"iris shapes {iris.features.shape} {iris.labels.shape}")
    check(cifar.features.shape == (10000, 3072)
          and cifar.labels.shape == (10000, 10)
          and float(cifar.features.min()) >= 0.0
          and float(cifar.features.max()) <= 1.0,
          f"cifar10 shapes {cifar.features.shape} {cifar.labels.shape}")
    base = NeuralNetConfiguration(
        activation="tanh", weight_init="vi", lr=0.1,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT,
        num_iterations=IRIS_ITERS, seed=42)
    conf = (list_builder(base, 2).hidden_layer_sizes([10], n_in=4, n_out=3)
            .override(1, layer_type=LayerType.OUTPUT,
                      loss_function=LossFunction.MCXENT).build())
    data = iris.normalize_zero_mean_unit_variance()
    net = MultiLayerNetwork(conf, device="cuda").init()
    s0 = net.score(data.features, data.labels)
    net.fit(data.features, data.labels)
    s1 = net.score(data.features, data.labels)
    ev = Evaluation()
    ev.eval(data.labels, net.output(data.features).float().cpu().numpy())
    row = {"iris_score": [s0, s1], "iris_accuracy": ev.accuracy(),
           "cifar10_class_counts": np.bincount(
               cifar.labels.argmax(1), minlength=10).tolist()}
    check(s1 < s0 and ev.accuracy() >= IRIS_MIN_ACCURACY,
          f"Iris did not train: {row}")
    return row


def serve_traffic(url, xs, prios):
    """POST every request at once from its own thread; (answers,
    latencies ms)."""
    answers, latencies, errors = [None] * len(xs), [None] * len(xs), []

    def client(i):
        t = time.perf_counter()
        try:
            answers[i] = np.asarray(post(url + "/v1/predict", {
                "features": xs[i].tolist(), "dtype": "int32",
                "priority": prios[i]})["output"], np.float32)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        latencies[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"requests failed: {errors}")
    return answers, latencies


def cli_serve(torch, ckpt, xs, prios, shapes, extra=()):
    """`python -m deeplearning4j_tpu_torch.cli serve --shapes ...` (and
    `extra` flags) as a subprocess on the checkpoint: its startup line, its
    stats after the requests, and its drained line."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
           "--model", ckpt, "--port", "0", "--shapes", shapes,
           "--max-delay-ms", "100", "--max-batch-rows", "8",
           "--default-deadline-ms", "60000", *extra]
    env = dict(os.environ, PYTHONPATH=root)
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env,
                            cwd=root)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    try:
        reader.start()
        while not lines and proc.poll() is None \
                and time.perf_counter() - t < 300:
            time.sleep(0.05)
        check(bool(lines), f"cli serve printed no startup line (exit "
                           f"{proc.poll()})")
        startup = json.loads(lines[0])
        start_s = time.perf_counter() - t
        answers, latencies = serve_traffic(startup["url"], xs, prios)
        stats = get_json(startup["url"] + "/v1/stats")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        reader.join(30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    drained = json.loads(lines[-1])
    return {"startup": startup, "start_s": start_s, "stats": stats,
            "latency_ms": latencies, "drained": drained,
            "returncode": proc.returncode}, answers


def api_serve(torch, kernels, td):
    """(c): the SLICE charTransformer served in process with batching=True,
    then batching=False, under mixed priorities and a default deadline; then
    its checkpoint through the CLI's `serve --shapes` in a subprocess."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import checkpoint

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=SLICE["n_blocks"],
                            n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"])
    conf = conf.with_compute_dtype("bfloat16")
    conf = conf.replace(confs=tuple(c.replace(attention_impl="flash")
                                    for c in conf.confs))
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    rng = np.random.RandomState(16)
    # int32 ids, as the requests carry them, so the direct checks replay
    # the warmed programs too
    xs = [rng.randint(0, SLICE["vocab"], (REQUEST_ROWS, SLICE["seq"]),
                      dtype=np.int32) for _ in range(REQUESTS_API)]
    prios = ["interactive" if i % 2 == 0 else "batch"
             for i in range(REQUESTS_API)]
    shapes = [(REQUEST_ROWS, SLICE["seq"]), (8, SLICE["seq"])]
    t = time.perf_counter()
    warm = net.warmup(shapes)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    warmed_misses = net.infer_cache.stats.misses
    n_attn = SLICE["n_blocks"]
    out, launches = {}, {}
    for batching in (True, False):
        name = "batched" if batching else "unbatched"
        server = net.serve(port=0, max_delay_ms=100.0, max_batch_rows=8,
                           batching=batching, default_deadline_ms=60000.0)
        kernels.reset_launches()
        try:
            t = time.perf_counter()
            answers, latencies = serve_traffic(server.url, xs, prios)
            wall_s = time.perf_counter() - t
            stats = server.stats()
        finally:
            server.drain()
        launches[name] = kernels.LAUNCHES["flash_attn_fwd"]
        flushes = sum(stats["batch_rows_hist"].values())
        want = n_attn * (flushes if batching else REQUESTS_API)
        check(launches[name] == want,
              f"{name}: flash launches {launches[name]} != {want}")
        errs = []
        for x, ans in zip(xs, answers):
            direct = net.output(x).float().cpu().numpy()
            check(ans.shape == direct.shape, f"answer shape {ans.shape}")
            errs.append(float(np.abs(ans - direct).max())
                        / float(np.abs(direct).max()))
        check(max(errs) < 2e-2,
              f"{name}: answers differ from net.output: {errs}")
        out[name] = {"wall_s": wall_s, "client_latency_ms": latencies,
                     "flushes": flushes, "flash_launches": launches[name],
                     "max_rel_err_vs_output": max(errs),
                     "fresh_compiles": stats["fresh_compiles"],
                     "batch_rows_hist": stats["batch_rows_hist"],
                     "priorities": {p: {k: v[k] for k in (
                         "requests", "latency_ms", "queue_depth")}
                         for p, v in stats["priorities"].items()}}
        if batching:
            for p in ("interactive", "batch"):
                check(stats["priorities"][p]["requests"]
                      == prios.count(p),
                      f"{p} requests {stats['priorities'][p]} != "
                      f"{prios.count(p)}")
        check(stats["fresh_compiles"] == warmed_misses,
              f"{name}: serving captured {stats['fresh_compiles']} - "
              f"{warmed_misses} programs")
    ckpt = os.path.join(td, "char_transformer")
    t = time.perf_counter()
    checkpoint.save(ckpt, net.params, conf=conf)
    save_s = time.perf_counter() - t
    del net
    gc.collect()
    torch.cuda.empty_cache()
    spec = ",".join(f"{b}x{s}" for b, s in shapes)
    cli, answers = cli_serve(torch, ckpt, xs, prios, spec)
    check(cli["startup"]["warmed"] == [list(s) for s in shapes],
          f"cli serve warmed {cli['startup']['warmed']}")
    check(cli["stats"]["fresh_compiles"]
          == cli["startup"]["fresh_compiles"] == len(shapes),
          f"cli serve captured under traffic: {cli['stats']['cache']}")
    check(cli["returncode"] == 0 and cli["drained"].get("drained"),
          f"cli serve did not drain: {cli['drained']}")
    check(all(a.shape == (REQUEST_ROWS * SLICE["seq"], SLICE["vocab"])
              and np.isfinite(a).all() for a in answers),
          "cli serve answers are malformed")
    out["cli"] = {"start_s": cli["start_s"], "checkpoint_save_s": save_s,
                  "warmed": cli["startup"]["warmed"],
                  "fresh_compiles_startup": cli["startup"]["fresh_compiles"],
                  "fresh_compiles_after": cli["stats"]["fresh_compiles"],
                  "client_latency_ms": cli["latency_ms"],
                  "priorities": {p: {k: v[k] for k in (
                      "requests", "latency_ms")}
                      for p, v in cli["stats"]["priorities"].items()},
                  "drained": cli["drained"]}
    out["warm"] = {"shapes": warm["shapes"], "seconds": warm_s,
                   "captures": warmed_misses}
    return out, launches


def api_checkpoint_listener(torch, kernels, td):
    """(d) and (e): a CheckpointListener's asynchronous saves during captured
    one-step `fit` calls at SLICE's width, each held array-equal to a
    synchronous save of the params it was taken at, with the snapshot's
    stall on the training thread; then a params_flat / set_params_flat round
    trip, after which the next step replays the captured graph."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CheckpointListener
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
    from deeplearning4j_tpu_torch.parallel import checkpoint

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=API_TRAIN_BLOCKS,
                            n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"], sparse_labels=True,
                            fused_updater=True, attention_block_skip=True,
                            attention_fused_bwd=True)
    conf = conf.with_compute_dtype("bfloat16")
    conf = conf.replace(confs=tuple(c.replace(attention_impl="flash",
                                              lr=TRAIN_LR)
                                    for c in conf.confs))
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    rng = np.random.RandomState(17)
    ids = rng.randint(0, SLICE["vocab"], (API_TRAIN_ROWS, SLICE["seq"] + 1))
    x = ids[:, :-1].astype(np.int32)
    y = ids[:, 1:].reshape(-1).astype(np.int32)
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(net.params))
    net.fit(x, y)  # the step's capture, outside the timed steps
    torch.cuda.synchronize()
    plain_ms = []  # the same step without a listener
    for _ in range(2):
        t = time.perf_counter()
        net.fit(x, y)
        plain_ms.append((time.perf_counter() - t) * 1e3)
    listener = CheckpointListener(os.path.join(td, "async0"),
                                  save_every_n=1, asynchronous=True)
    net.set_listeners([listener])
    stalls, step_ms = [], []
    real = checkpoint.save_async

    def timed(*a, **kw):
        t = time.perf_counter()
        thread = real(*a, **kw)
        stalls.append((time.perf_counter() - t) * 1e3)
        return thread

    checkpoint.save_async = timed
    kernels.reset_launches()
    try:
        for k in range(API_TRAIN_STEPS):
            listener.directory = os.path.join(td, f"async{k}")
            t = time.perf_counter()
            net.fit(x, y)
            step_ms.append((time.perf_counter() - t) * 1e3)
            # the same params, written synchronously before the next step
            checkpoint.save(os.path.join(td, f"sync{k}"), net.params)
        checkpoint.join_async()
    finally:
        checkpoint.save_async = real
    train_launches = dict(kernels.LAUNCHES)
    net.set_listeners([])
    equal, moved = [], []
    for k in range(API_TRAIN_STEPS):
        with np.load(os.path.join(td, f"async{k}", "arrays.npz")) as za, \
                np.load(os.path.join(td, f"sync{k}", "arrays.npz")) as zs:
            equal.append(sorted(za.files) == sorted(zs.files) and all(
                np.array_equal(za[f], zs[f]) for f in za.files))
            if k:
                with np.load(os.path.join(td, f"sync{k - 1}",
                                          "arrays.npz")) as zp:
                    moved.append(any(not np.array_equal(zs[f], zp[f])
                                     for f in zs.files))
    check(all(equal), f"an asynchronous checkpoint differs from the params "
                      f"at its step: {equal}")
    check(all(moved), "the params did not change between steps")
    check(listener.saves == API_TRAIN_STEPS,
          f"the listener saved {listener.saves} times")
    # (e) the flat vector's round trip keeps the captured step's addresses
    books = net.step_cache.stats.as_dict()
    ptrs = [t.data_ptr() for t in tree_leaves(net.params)]
    t = time.perf_counter()
    flat = net.params_flat()
    net.set_params_flat(flat)
    torch.cuda.synchronize()
    flat_ms = (time.perf_counter() - t) * 1e3
    same = bool(torch.equal(net.params_flat(), flat))
    net.fit(x, y)
    after = net.step_cache.stats.as_dict()
    row = {"config": dict(SLICE, n_blocks=API_TRAIN_BLOCKS,
                          rows=API_TRAIN_ROWS), "param_bytes": nbytes,
           "steps": API_TRAIN_STEPS, "step_ms_without_save": plain_ms,
           "step_ms_with_async_save": step_ms,
           "snapshot_stall_ms": stalls,
           "async_equal_to_sync": equal, "launches": train_launches,
           "params_flat_elements": flat.numel(),
           "params_flat_roundtrip_ms": flat_ms,
           "params_flat_roundtrip_exact": same,
           "step_cache_before": books, "step_cache_after": after}
    check(same and [t.data_ptr() for t in tree_leaves(net.params)] == ptrs,
          f"set_params_flat did not write in place: {row}")
    check(after["misses"] == books["misses"]
          and after["hits"] == books["hits"] + 1,
          f"the step after set_params_flat did not replay: {row}")
    return row


def phase_datasets_serve_api(torch, kernels):
    """The builtin datasets, the serving front's options and the API of
    the listener and the flat params, at full width (module docstring,
    item 14). Returns the
    flash forward's launches by path and the backward kernels' launches."""
    import shutil
    import tempfile

    td = tempfile.mkdtemp(prefix="dl4j-api-")
    t0 = time.perf_counter()
    try:
        mnist = api_mnist_cli(torch, td)
        pull = api_prefetch_pull(torch)
        iris = api_iris_cifar(torch)
        gc.collect()
        torch.cuda.empty_cache()
        serve, serve_launches = api_serve(torch, kernels, td)
        gc.collect()
        torch.cuda.empty_cache()
        ckpt = api_checkpoint_listener(torch, kernels, td)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    emit({"phase": "datasets_serve_api", "seconds": time.perf_counter() - t0,
          "mnist_mlp": mnist, "prefetch_pull": pull, "iris_cifar10": iris,
          "serve": serve,
          "checkpoint_listener": ckpt,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return serve_launches, ckpt["launches"]


#: the conv_nets phase (slice 17): bench.py's LeNet-5 (:205-208, batch
#: 4,096) and VGG-CIFAR10 (:322-326, width 64, batch 512) cells, `_mixed`,
#: trained through `MultiLayerNetwork.fit` (the bench's DataParallelTrainer
#: at world size 1 is the data_parallel phase's), `turns` steps a path in
#: turns, then `epochs` epochs of the captured net and the held-out rows
CONV_LENET = dict(batch=4096, train=54000, held_out=6000, turns=6, epochs=4)
#: VGG at lr 0.01, not the zoo's 0.05: at 0.05 the bf16 net's loss reaches
#: 14.3-14.9 within its first 8 steps from each of 8 initial draws and its
#: 2-epoch accuracy is the draw's luck (0.33-1.0); at 0.01 no draw's loss
#: passes 3.4 and each ends at 1.0 (`--seed-sweeps`, PERF.md), as the
#: flagship trains at TRAIN_LR. The JAX package's VGG from the same draw
#: climbs as high at 0.05 in its first 8 steps (`vgg_lr_witness.py`)
CONV_VGG = dict(width=64, batch=512, train=9004, held_out=1000, turns=6,
                epochs=2, lr=0.01)
CONV_MIN_ACCURACY = 0.5  # chance (0.1) + 0.4
CONV_TOL = 2e-2          # bf16 compute: 2e-2 of max|leaf|
#: conv_f32, in a child process of its own: the CLI on mnist: and cifar10:
#: (f32; the VGG at `cifar_width`), the card's f32 LeNet output against the
#: CPU port's on `rows` rows (1e-4 relative), the f32 VGG's captured and
#: eager steps against the CPU port's (`vgg_steps` batches of `vgg_batch`,
#: `vgg_rel_tol` of max|leaf|: the first conv's update moves ~4e-5 on the
#: CPU alone when its inputs move by 1e-7 relative, and the card's conv
#: outputs differ from the CPU's by ~1e-6), the checkpointed LeNet fit
#: (`ckpt_batches` batches of `ckpt_batch`, SIGTERM after `ckpt_stop`), and
#: `det_iters` timed conv passes a cuDNN setting
CONV_F32 = dict(mnist=8192, cifar=2048, cifar_width=64, rows=512,
                rel_tol=1e-4, vgg_batch=512, vgg_steps=1, vgg_rel_tol=1e-3,
                ckpt_batch=4096, ckpt_batches=4, ckpt_stop=2, det_iters=10)
CONV_DROPOUT = dict(dropout=0.5, batch=4096, turns=4)


def conv_data(kind, n):
    """The MNIST or CIFAR-10 stand-in (the fetchers' own; real data where a
    copy is configured) as host arrays: features [n, C*H*W], one-hot
    labels."""
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        Cifar10DataFetcher, MnistDataFetcher)

    ds = (MnistDataFetcher() if kind == "mnist"
          else Cifar10DataFetcher()).fetch(n)
    return (np.ascontiguousarray(ds.features, np.float32),
            np.ascontiguousarray(ds.labels, np.float32))


def conv_conf(name, width=64, dtype="bfloat16", dropout=0.0, lr=None):
    """lenet5() or vgg_cifar10(width) with `compute_dtype` (bench.py's
    `_mixed` for bf16), dropout on LeNet's dense layer, VGG at `lr` (the
    zoo's 0.05 by default)."""
    from deeplearning4j_tpu_torch.models.zoo import lenet5, vgg_cifar10

    conf = (lenet5() if name == "lenet5" else
            vgg_cifar10(width=width) if lr is None else
            vgg_cifar10(width=width, lr=lr))
    if dropout:
        conf = conf.replace(confs=tuple(
            c.replace(dropout=dropout) if i == 4 else c
            for i, c in enumerate(conf.confs)))
    return conf.with_compute_dtype(dtype) if dtype else conf


def device_batches(torch, x, y, batch):
    """(x, y) cut into batches of `batch` rows, on the card."""
    xd, yd = (torch.as_tensor(a, device="cuda") for a in (x, y))
    return [(xd[i:i + batch], yd[i:i + batch])
            for i in range(0, len(x), batch)]


def named_leaves(net, ema):
    """The network's leaves as (layer.name, tensor): the BatchNorm EMA's
    (ema=True) or all the others."""
    return [(f"{i}.{k}", t) for i, layer in enumerate(net.params)
            for k, t in sorted(layer.items()) if k.startswith("ema_") == ema]


def leaves_gap(torch, got, want):
    """max |got - want| over matching leaves, max |want|, bitwise; None
    when there are none."""
    pairs = list(zip(got, want))
    if not pairs:
        return None
    return {"max_abs_diff": max(float((a.float() - b.float()).abs().max())
                                for (_, a), (_, b) in pairs),
            "max_abs": max(float(b.float().abs().max())
                           for _, (_, b) in pairs),
            "bitwise": all(torch.equal(a, b) for (_, a), (_, b) in pairs)}


def gap_ok(gap, tol=CONV_TOL):
    return gap is None or gap["max_abs_diff"] <= tol * max(gap["max_abs"],
                                                           1e-12)


class LeafCopy:
    """A snapshot of a network's params tree (copies), as a stand-in net
    for `named_leaves`."""

    def __init__(self, net):
        self.params = tuple({k: v.detach().clone() for k, v in layer.items()}
                            for layer in net.params)


def copy_params(net, device):
    """A copy of the network's params tree on `device`."""
    return tuple({k: v.detach().to(device).clone() for k, v in layer.items()}
                 for layer in net.params)


def one_step_gaps(torch, captured, eager, batch):
    """One `fit` step of the captured and of the eager net on `batch`, the
    eager net first given the captured one's params: the params' gap and
    the EMA's (None without BatchNorm)."""
    eager.params = copy_params(captured, "cuda")
    captured.fit(*batch)
    eager.fit(*batch)
    return {"params": leaves_gap(torch, named_leaves(captured, False),
                                 named_leaves(eager, False)),
            "ema": leaves_gap(torch, named_leaves(captured, True),
                              named_leaves(eager, True))}


def program_steps(torch, conf, snap, batches, bucket):
    """The captured step's own program run eagerly (no graph) on `snap`'s
    params in place, one call a batch padded to `bucket` rows: the math a
    replay does, the BatchNorm EMA advance included, uncaptured."""
    from deeplearning4j_tpu_torch.optimize import step_cache as sc

    program = sc._finetune_program(conf)
    for x, y in batches:
        xp, yp, w = sc.CompiledProgramCache.pad_batch(x, y, bucket)
        sc._write_params(snap.params, program(snap.params, xp, yp, w))
    return snap


CONV_KINDS = (("pooling", ("pool",)),
              ("layout", ("nchwtonhwc", "nhwctonchw")),
              ("conv_backward", ("dgrad", "wgrad", "bprop", "backward",
                                 "convolve_bwd")),
              ("conv_forward", ("fprop", "conv", "implicit", "xmma_fprop")),
              ("gemm", ("gemm", "nvjet", "cublas", "cutlass")),
              ("reduction", ("reduce", "welford", "norm")),
              ("copy_cast", ("copy", "cast")),
              ("elementwise", ("elementwise", "vectorized", "unrolled")))


def conv_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in CONV_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def conv_profile(torch, kernels, fn, phase, kind=None) -> dict:
    """One fn() call under `torch.profiler`: device ms by kind of kernel
    (`kind(name)`, by default `conv_kind`: `CONV_KINDS`), the largest
    kernels, the kernel count and the wall time. Prints the row and returns
    it."""
    kind = kind or conv_kind
    from torch.profiler import ProfilerActivity, profile

    saved = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels.LAUNCHES.update(saved)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    by_kind = {}
    for e in events:
        k = kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.device_time_total / 1e3
    total_ms = sum(e.device_time_total for e in events) / 1e3
    row = {"phase": phase, "wall_ms": wall_ms, "device_ms": total_ms,
           "idle_share": 1.0 - total_ms / wall_ms,
           "kernel_count": sum(e.count for e in events),
           "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
           "top": [{"name": e.key[:90], "kind": kind(e.key),
                    "calls": e.count, "ms": e.device_time_total / 1e3}
                   for e in events[:12]]}
    emit(row)
    return row


def conv_net_run(torch, kernels, name, conf, data, cfg):
    """One conv net on the card (module docstring, item 15): captured and
    eager `fit` steps in turns from the same weights, the captured path
    checked against its own program run uncaptured (params and EMA), the
    ragged tail against an unpadded uncaptured step, `output` timed and
    read after a step without a new capture, then `epochs` epochs of the
    captured net and its held-out accuracy. Returns the row (emitted by
    the caller) and the profile rows."""
    from deeplearning4j_tpu_torch.nn.multilayer import (has_batchnorm,
                                                        network_output)

    x, y = data
    n_train, batch = cfg["train"], cfg["batch"]
    batches = device_batches(torch, x[:n_train], y[:n_train], batch)
    held_x, held_y = x[n_train:n_train + cfg["held_out"]], \
        y[n_train:n_train + cfg["held_out"]]
    captured, eager = twin_nets(conf)
    nets = {"captured": captured, "eager": eager}
    start = LeafCopy(captured)
    turns = {k: [] for k in nets}
    for step in range(cfg["turns"]):
        xb, yb = batches[step % len(batches)]
        for which in (list(nets) if step % 2 == 0 else list(nets)[::-1]):
            turns[which].append(event_ms(
                torch, lambda n=nets[which]: n.fit(xb, yb)))
    step_ms = {k: median(v[1:]) for k, v in turns.items()}
    gap = leaves_gap(torch, named_leaves(captured, False),
                     named_leaves(eager, False))
    ema_gap = leaves_gap(torch, named_leaves(captured, True),
                         named_leaves(eager, True))
    # the same steps through the program uncaptured: the graph's own math
    ref = program_steps(torch, conf, start,
                        [batches[s % len(batches)]
                         for s in range(cfg["turns"])], batch)
    program_gap = leaves_gap(torch, named_leaves(captured, False),
                             named_leaves(ref, False))
    program_ema_gap = leaves_gap(torch, named_leaves(captured, True),
                                 named_leaves(ref, True))
    # one step of each path from the same params (the eager net takes the
    # captured one's): the turns' trajectories part for a BatchNorm net
    one_step = one_step_gaps(torch, captured, eager,
                             batches[cfg["turns"] % len(batches)])
    profiles = {
        "captured": conv_profile(torch, kernels,
                                 lambda: captured.fit(*batches[0]),
                                 f"conv_profile_{name}"),
        "eager": conv_profile(torch, kernels,
                              lambda: eager.fit(*batches[0]),
                              f"conv_profile_{name}_eager")}
    del eager, nets
    torch.cuda.empty_cache()
    # output at the batch: captured once, then replayed
    xo = batches[0][0]
    captured.output(xo)
    out_ms = [event_ms(torch, lambda: captured.output(xo)) for _ in range(5)]
    misses = (captured.step_cache.stats.misses,
              captured.infer_cache.stats.misses)
    before = captured.output(xo)
    captured.fit(*batches[1])
    after = captured.output(xo)
    with torch.inference_mode():
        want = network_output(conf, captured.params, xo)
    read = {"max_abs_diff": float((after - want).abs().max()),
            "max_abs": float(want.abs().max()),
            "changed": not torch.equal(before, after)}
    # the ragged tail: padded into the batch's bucket against unpadded
    tail = batches[-1]
    snap = LeafCopy(captured)
    captured.fit(*tail)
    program_steps(torch, conf, snap, [tail], int(tail[0].shape[0]))
    tail_gap = leaves_gap(torch, named_leaves(captured, False)
                          + named_leaves(captured, True),
                          named_leaves(snap, False) + named_leaves(snap, True))
    # epochs of the captured net, then the held-out rows
    t = time.perf_counter()
    for _ in range(cfg["epochs"]):
        for xb, yb in batches:
            captured.fit(xb, yb)
    torch.cuda.synchronize()
    epochs_s = time.perf_counter() - t
    ev = captured.evaluate(held_x, held_y, batch_size=batch)
    traffic = (captured.step_cache.stats.misses - misses[0],
               captured.infer_cache.stats.misses - misses[1])
    med = step_ms["captured"]
    row = {"batch": batch, "train_rows": n_train,
           "tail_rows": int(tail[0].shape[0]),
           "step_ms": med, "step_ms_eager": step_ms["eager"],
           "samples_per_s": batch * 1e3 / med,
           "samples_per_s_eager": batch * 1e3 / step_ms["eager"],
           "turns_ms": turns,
           "idle_share": idle_shares(profiles["captured"], med),
           "idle_share_eager": idle_shares(profiles["eager"],
                                           step_ms["eager"]),
           "output_ms": median(out_ms), "output_ms_all": out_ms,
           "captured_vs_eager": gap, "captured_vs_eager_ema": ema_gap,
           "captured_vs_program": program_gap,
           "captured_vs_program_ema": program_ema_gap,
           "one_step_captured_vs_eager": one_step,
           "output_reads_new_params": read, "tail_vs_unpadded": tail_gap,
           "epochs": cfg["epochs"], "epochs_s": epochs_s,
           "epoch_samples_per_s": cfg["epochs"] * n_train / epochs_s,
           "held_out_rows": len(held_x), "accuracy": ev.accuracy(),
           "captures_under_traffic": {"train": traffic[0],
                                      "infer": traffic[1]},
           "graph": graph_books(captured)}
    # a BatchNorm net's trajectories part: 1 / sqrt(var + eps) of a
    # near-dead channel amplifies each step's rounding, in f32 too, and the
    # eager EMA comes from a forward after the step (JAX's uncached path).
    # Its paths are held one step at a time from the same params here
    # (params and EMA), and each against the CPU port in f32 (conv_f32's
    # `vgg_f32_vs_cpu`)
    check(gap_ok(gap) or has_batchnorm(conf),
          f"{name}: captured and eager params disagree: {gap}")
    check(gap_ok(one_step["params"]) and gap_ok(one_step["ema"]),
          f"{name}: one captured and one eager step from the same params "
          f"disagree: {one_step}")
    check(gap_ok(program_gap) and gap_ok(program_ema_gap),
          f"{name}: the captured steps disagree with their program run "
          f"uncaptured: {program_gap} {program_ema_gap}")
    check(read["max_abs_diff"] <= 1e-3 * read["max_abs"] and read["changed"],
          f"{name}: output after a step does not read the new params: "
          f"{read}")
    check(gap_ok(tail_gap), f"{name}: the padded tail disagrees with an "
          f"unpadded step: {tail_gap}")
    check(traffic == (0, 0), f"{name}: captures under traffic: {traffic}")
    check(captured.step_cache.stats.misses == 1,
          f"{name}: the train step was captured "
          f"{captured.step_cache.stats.misses} times")
    check((program_ema_gap is not None) == has_batchnorm(conf),
          f"{name}: the EMA leaves do not follow the conf's BatchNorm")
    return row, profiles


def phase_conv_lenet(torch, kernels):
    t0 = time.perf_counter()
    data = conv_data("mnist", CONV_LENET["train"] + CONV_LENET["held_out"])
    row, profiles = conv_net_run(torch, kernels, "lenet5",
                                 conv_conf("lenet5"), data, CONV_LENET)
    emit({"phase": "conv_lenet", "seconds": time.perf_counter() - t0,
          "config": "bench.py:205-208 _mixed(lenet5()), batch 4096",
          **row})
    check(row["accuracy"] >= CONV_MIN_ACCURACY,
          f"LeNet held-out accuracy {row['accuracy']} is not chance + 0.4")
    return profiles


def phase_conv_vgg(torch, kernels):
    t0 = time.perf_counter()
    data = conv_data("cifar10", CONV_VGG["train"] + CONV_VGG["held_out"])
    row, profiles = conv_net_run(
        torch, kernels, "vgg_cifar10",
        conv_conf("vgg_cifar10", width=CONV_VGG["width"],
                  lr=CONV_VGG["lr"]), data, CONV_VGG)
    emit({"phase": "conv_vgg", "seconds": time.perf_counter() - t0,
          "config": "bench.py:322-326 _mixed(vgg_cifar10(width=64)), "
                    "batch 512, lr 0.01", **row})
    check(row["captured_vs_program_ema"] is not None,
          "the VGG net has no BatchNorm EMA")
    check(row["accuracy"] >= CONV_MIN_ACCURACY,
          f"VGG held-out accuracy {row['accuracy']} is not chance + 0.4")
    return profiles


#: `--seed-sweeps`: the two recipes whose outcome hangs on the initial draw
#: (CONV_VGG's lr, PRE_AE's finetune cut): VGG from `vgg_seeds` draws at
#: each lr of `vgg_lrs` (the zoo's 0.05, the phase's 0.01), the deep AE's
#: card-vs-CPU cut from `ae_seeds` draws at each of `ae_iterations`
SEED_SWEEPS = dict(vgg_seeds=8, vgg_lrs=(0.05, 0.01), ae_seeds=4,
                   ae_iterations=(5, 10))


def conv_vgg_seeds(torch, kernels):
    """How VGG's 2-epoch run depends on its initial draw: for each lr and
    seed, the largest score of the first 8 steps, the score at the end,
    the held-out accuracy. Emits one line; checks nothing."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    cfg = CONV_VGG
    x, y = conv_data("cifar10", cfg["train"] + cfg["held_out"])
    batches = device_batches(torch, x[:cfg["train"]], y[:cfg["train"]],
                             cfg["batch"])
    rows = []
    for lr in SEED_SWEEPS["vgg_lrs"]:
        conf = conv_conf("vgg_cifar10", width=cfg["width"], lr=lr)
        for seed in range(SEED_SWEEPS["vgg_seeds"]):
            net = MultiLayerNetwork(conf, device="cuda", seed=seed).init()
            top = 0.0
            for ep in range(cfg["epochs"]):
                for i, (xb, yb) in enumerate(batches):
                    if ep == 0 and i < 8:
                        top = max(top, float(net.score(xb, yb)))
                    net.fit(xb, yb)
            rows.append({"lr": lr, "seed": seed, "max_score_first_8": top,
                         "score_end": float(net.score(*batches[0])),
                         "accuracy": net.evaluate(
                             x[cfg["train"]:], y[cfg["train"]:],
                             batch_size=cfg["batch"]).accuracy()})
            del net
    emit({"phase": "conv_vgg_seeds", "gpu": gpu_line(), "rows": rows})


def pre_ae_seeds(torch):
    """The deep AE's card-vs-CPU cut from several draws and finetune
    lengths, ungated: each row's gaps against their gates. Emits one
    line."""
    from deeplearning4j_tpu_torch.models import zoo

    conf = zoo.deep_autoencoder()
    x = pre_curves(PRE_AE["rows"])
    rows = []
    for iterations in SEED_SWEEPS["ae_iterations"]:
        for seed in range(SEED_SWEEPS["ae_seeds"]):
            pre, fine = pre_ae_cut(torch, conf, x, iterations, seed,
                                   gated=False)
            rows.append({"iterations": iterations, "seed": seed,
                         "pretrain": pre, "finetune": fine})
    emit({"phase": "pretrain_ae_seeds", "gpu": gpu_line(), "rows": rows})


def dense_mask(torch, conf, key, shape):
    """The input-dropout mask of LeNet's dense layer (layer 4) in the first
    solver iteration of a step on `key`, drawn as the layers draw it."""
    from deeplearning4j_tpu_torch.nd import random as nd_random

    sub = nd_random.split(key)[1]
    layer_key = nd_random.split(sub, conf.n_layers)[4]
    kdrop = nd_random.split(layer_key)[0]
    return nd_random.dropout_mask(kdrop, 1.0 - conf.conf(4).dropout, shape)


def phase_conv_dropout(torch, kernels):
    """LeNet with dropout 0.5 on its dense layer, `_mixed`, batch 4,096:
    the card's masks equal the CPU's bit for bit, captured and eager steps
    in turns agree within bf16, the captured graph draws its masks from
    its key input (the same key replays bitwise, another key gives other
    params), and two steps' masks differ."""
    from deeplearning4j_tpu_torch.nd import random as nd_random

    t0 = time.perf_counter()
    cfg = CONV_DROPOUT
    conf = conv_conf("lenet5", dropout=cfg["dropout"])
    x, y = conv_data("mnist", cfg["batch"])
    (xb, yb), = device_batches(torch, x, y, cfg["batch"])
    shape = (cfg["batch"], 800)
    key = nd_random.split_host((0, 123))[1]
    masks_equal = torch.equal(
        dense_mask(torch, conf, torch.tensor(key, device="cuda"),
                   shape).cpu(),
        dense_mask(torch, conf, torch.tensor(key), shape))
    captured, eager = twin_nets(conf)
    # the eager twin skipped init, which takes the stream's first key
    eager._key = captured._key
    nets = {"captured": captured, "eager": eager}
    turns = {k: [] for k in nets}
    for step in range(cfg["turns"]):
        for which in (list(nets) if step % 2 == 0 else list(nets)[::-1]):
            turns[which].append(event_ms(
                torch, lambda n=nets[which]: n.fit(xb, yb)))
    gap = leaves_gap(torch, named_leaves(captured, False),
                     named_leaves(eager, False))
    del eager, nets
    # the graph's key input: the same key replays bitwise, another differs
    snap = LeafCopy(captured)
    key0 = captured._key
    results = []
    for k in (key0, key0, nd_random.split_host(key0)[0]):
        with torch.no_grad():
            for (_, t), (_, s) in zip(named_leaves(captured, False),
                                      named_leaves(snap, False)):
                t.copy_(s)
        captured._key = k
        captured.fit(xb, yb)
        results.append(LeafCopy(captured))
    same = leaves_gap(torch, named_leaves(results[0], False),
                      named_leaves(results[1], False))
    other = leaves_gap(torch, named_leaves(results[0], False),
                       named_leaves(results[2], False))
    # two successive steps' dense masks
    k1, k2 = (torch.tensor(nd_random.split_host(k)[1], device="cuda")
              for k in (key0, nd_random.split_host(key0)[0]))
    m1, m2 = (dense_mask(torch, conf, k, shape) for k in (k1, k2))
    row = {"phase": "conv_dropout", "seconds": time.perf_counter() - t0,
           "dropout": cfg["dropout"], "batch": cfg["batch"],
           "masks_equal_cpu": masks_equal,
           "step_ms": median(turns["captured"][1:]),
           "step_ms_eager": median(turns["eager"][1:]), "turns_ms": turns,
           "captured_vs_eager": gap, "same_key_replay": same,
           "other_key_replay": other,
           "mask_keep_share": float(m1.ne(0).float().mean()),
           "masks_differ_share": float(m1.ne(m2).float().mean()),
           "step_cache": captured.step_cache.stats.as_dict()}
    emit(row)
    check(masks_equal, "the card's dropout masks differ from the CPU's")
    check(gap_ok(gap), f"captured and eager dropout steps disagree: {gap}")
    check(same["bitwise"], f"one key replayed two ways: {same}")
    check(not other["bitwise"], "another key gave the same step")
    check(row["masks_differ_share"] > 0.3, "two steps drew one mask")
    check(captured.step_cache.stats.misses == 1,
          "the dropout step was captured more than once")


def conv_det_times(torch, iters):
    """fwd + bwd ms of each conv shape on the paths (LeNet's two at batch
    4,096 in f32 and bf16, VGG's first three at 512 in bf16) with cuDNN's
    deterministic algorithms, as the port runs them, and with its default
    ones, TF32 off in both; CUDA events, median of `iters`."""
    shapes = [("lenet_conv1", (4096, 1, 28, 28), (20, 1, 5, 5), 0),
              ("lenet_conv2", (4096, 20, 12, 12), (50, 20, 5, 5), 0),
              ("vgg_conv1", (512, 3, 32, 32), (64, 3, 3, 3), 1),
              ("vgg_conv2", (512, 64, 16, 16), (128, 64, 3, 3), 1),
              ("vgg_conv3", (512, 128, 8, 8), (256, 128, 3, 3), 1)]
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.allow_tf32, cudnn.benchmark)
    rows = []
    try:
        for name, xs, ws, pad in shapes:
            for dt in ((torch.float32, torch.bfloat16)
                       if name.startswith("lenet") else (torch.bfloat16,)):
                x = torch.randn(xs, device="cuda", dtype=dt)
                w = torch.randn(ws, device="cuda", dtype=dt)
                geo = ([1, 1], [pad, pad], [1, 1], False, [0, 0], 1)
                out = torch.ops.aten.convolution(x, w, None, *geo)
                g = torch.randn_like(out)
                row = {"name": name, "dtype": str(dt).replace("torch.", "")}
                for det in (True, False):
                    cudnn.deterministic, cudnn.allow_tf32 = det, False
                    cudnn.benchmark = False

                    def run():
                        torch.ops.aten.convolution(x, w, None, *geo)
                        torch.ops.aten.convolution_backward(
                            g, x, w, None, *geo, [name != "lenet_conv1"
                                                  and name != "vgg_conv1",
                                                  True, False])

                    run()
                    row["deterministic_ms" if det else "default_ms"] = \
                        median([event_ms(torch, run) for _ in range(iters)])
                row["cost"] = row["deterministic_ms"] / row["default_ms"]
                rows.append(row)
    finally:
        cudnn.deterministic, cudnn.allow_tf32, cudnn.benchmark = prev
    return rows


def vgg_f32_vs_cpu(torch, cfg, device="cuda"):
    """f32 VGG-CIFAR10 at `cifar_width`, captured and eager, on `device`
    and on the CPU, one step at a time: before each of `vgg_steps` batches
    of `vgg_batch` CIFAR stand-in rows, every net takes the device's
    captured net's params. The gaps are the largest over the steps, each
    relative to max|leaf|: the device's captured step against the CPU's
    (the same program) and its eager step against the CPU's eager one,
    params and EMA, which `ok` holds to `vgg_rel_tol`; and, reported, the
    two paths on each device, which differ by JAX's own design: the
    captured variance is s2 / n - mean^2 from raw sums, the eager one
    two-pass, and the eager EMA comes from a forward after the step; the
    CPU's step on inputs moved by ~1e-7 relative against its step on the
    inputs (how far rounding alone moves a step); the leaves furthest
    apart (captured, the worst step); and each conv's forward and
    gradients against float64 (`conv_vs_f64`)."""
    from deeplearning4j_tpu_torch.nn.layers import conv
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        feed_forward)

    conf = conv_conf("vgg_cifar10", width=cfg["cifar_width"], dtype="")
    x, y = conv_data("cifar10", cfg["vgg_batch"] * cfg["vgg_steps"])
    # the yardstick: the CPU's step on inputs moved by ~1e-7 relative
    x_moved = (x * (1 + 1e-7 * np.random.RandomState(0).standard_normal(
        x.shape))).astype(np.float32)
    nets = {}
    for dev, path in ((device, "captured"), (device, "eager"),
                      ("cpu", "captured"), ("cpu", "eager"),
                      ("cpu", "moved")):
        net = MultiLayerNetwork(conf, device=dev, seed=0).init()
        net.use_step_cache = path != "eager"
        nets[dev, path] = net
    lead = nets[device, "captured"]
    start = copy_params(lead, "cpu")
    pairs = {"captured_vs_cpu": ((device, "captured"), ("cpu", "captured")),
             "eager_vs_cpu": ((device, "eager"), ("cpu", "eager")),
             "captured_vs_eager": ((device, "captured"), (device, "eager")),
             "cpu_captured_vs_eager": (("cpu", "captured"), ("cpu", "eager")),
             "cpu_moved_input_vs_cpu": (("cpu", "moved"), ("cpu", "captured"))}
    worst = {f"{k}_{part}": 0.0 for k in pairs for part in ("params", "ema")}
    top = []
    t = time.perf_counter()
    for i in range(0, len(x), cfg["vgg_batch"]):
        before = copy_params(lead, "cpu")
        for (dev, path), net in nets.items():
            if net is not lead:
                net.params = copy_params(lead, dev)
        for (dev, path), net in nets.items():
            net.fit(torch.as_tensor((x_moved if path == "moved" else x)
                                    [i:i + cfg["vgg_batch"]], device=dev),
                    torch.as_tensor(y[i:i + cfg["vgg_batch"]], device=dev))
        for k, (a, b) in pairs.items():
            for part, ema in (("params", False), ("ema", True)):
                gap = leaves_gap(torch,
                                 [(n, v.cpu()) for n, v in
                                  named_leaves(nets[a], ema)],
                                 [(n, v.cpu()) for n, v in
                                  named_leaves(nets[b], ema)])
                rel = gap["max_abs_diff"] / max(gap["max_abs"], 1e-12)
                if k == "captured_vs_cpu" and part == "params" \
                        and rel >= worst[f"{k}_{part}"]:
                    top = sorted(
                        ({"leaf": name, "step": i // cfg["vgg_batch"],
                          "diff": float((v.cpu() - w).abs().max()),
                          "max_abs": float(w.abs().max()),
                          "update": float((w - before[int(name.split(".")[0])]
                                           [name.split(".")[1]]).abs().max())}
                         for (name, v), (_, w) in zip(
                             named_leaves(nets[a], False),
                             named_leaves(nets[b], False))),
                        key=lambda r: -r["diff"])[:4]
                worst[f"{k}_{part}"] = max(worst[f"{k}_{part}"], rel)
    seconds = time.perf_counter() - t
    # each conv in f32 on the device (the port's cuDNN setting) and on the
    # CPU against float64, at its input from the first batch's forward
    with torch.no_grad():
        acts = feed_forward(conf, start, torch.as_tensor(x[:cfg["vgg_batch"]]),
                            training=True)
    conv_vs_f64 = []
    gen = torch.Generator().manual_seed(0)
    for li, h in ((0, torch.as_tensor(x[:cfg["vgg_batch"]]).reshape(
            -1, 3, 32, 32)), (3, acts[2]), (6, acts[5])):
        w = start[li]["W"]
        out64 = torch.ops.aten.convolution(h.double(), w.double(), None,
                                           [1, 1], [1, 1], [1, 1], False,
                                           [0, 0], 1)
        g = torch.randn(out64.shape, generator=gen)
        gx64, gw64, _ = torch.ops.aten.convolution_backward(
            g.double(), h.double(), w.double(), None, [1, 1], [1, 1],
            [1, 1], False, [0, 0], 1, [True, True, False])
        row = {"layer": li, "input": list(h.shape)}
        for dev in (device, "cpu"):
            hd, wd = (h.to(dev).requires_grad_(), w.to(dev).requires_grad_())
            with torch.enable_grad():
                out = conv.conv2d(hd, wd, (1, 1), (1, 1))
                gx, gw = torch.autograd.grad(out, (hd, wd), g.to(dev))
            row[dev] = {name: float((a.detach().double().cpu()
                                     - ref).abs().max() / ref.abs().max())
                        for name, a, ref in (("out", out, out64),
                                             ("grad_x", gx, gx64),
                                             ("grad_w", gw, gw64))}
        conv_vs_f64.append(row)
    return {"width": cfg["cifar_width"], "batch": cfg["vgg_batch"],
            "steps": cfg["vgg_steps"], "seconds": seconds,
            "rel_gaps": worst, "captured_vs_cpu_top_leaves": top,
            "conv_vs_f64": conv_vs_f64,
            "ok": all(worst[f"{k}_{part}"] <= cfg["vgg_rel_tol"]
                      for k in ("captured_vs_cpu", "eager_vs_cpu")
                      for part in ("params", "ema"))}


def conv_f32_child(workdir) -> int:
    """conv_f32's child process (`chip_smoke.py --conv-f32-child DIR`):
    run with PyTorch's default global flags (cuDNN TF32 on), which the
    parent's do not reach. Prints one JSON line; exits 1 on a failed
    check."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.nn.layers import conv
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        feed_forward)
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network
    from deeplearning4j_tpu_torch.reliability import TrainingInterrupted

    cfg = CONV_F32
    out = {"tf32_flags": {"cudnn_allow_tf32":
                          torch.backends.cudnn.allow_tf32,
                          "matmul_allow_tf32":
                          torch.backends.cuda.matmul.allow_tf32,
                          "cudnn_deterministic":
                          torch.backends.cudnn.deterministic}}
    ok = True
    # the CLI on both stand-ins, f32
    cli = {}
    for scheme, n, spec in (("mnist", cfg["mnist"], "lenet5"),
                            ("cifar10", cfg["cifar"],
                             f"vgg_cifar10:width={cfg['cifar_width']}")):
        ck = os.path.join(workdir, scheme)
        uri = f"{scheme}:{n}"
        t = time.perf_counter()
        rc1, train = cli_json(cli_main, [
            "train", "--input", uri, "--zoo", spec, "--output", ck,
            "--properties", "epochs=2,batch=1024"])
        pred_csv = os.path.join(workdir, f"{scheme}.csv")
        rc2 = cli_main(["predict", "--input", uri, "--model", ck,
                        "--output", pred_csv, "--batch", "1024"])
        rc3, test = cli_json(cli_main, ["test", "--input", uri, "--model",
                                        ck, "--batch", "1024"])
        with open(pred_csv) as f:
            n_pred = sum(1 for _ in f) - 1
        cli[scheme] = {"zoo": spec, "rcs": [rc1, rc2, rc3],
                       "score": train["score"],
                       "train_seconds": train["train_seconds"],
                       "compile_seconds": train["compile_seconds"],
                       "predictions": n_pred,
                       "accuracy": test["accuracy"],
                       "wall_s": time.perf_counter() - t}
        ok &= (rc1, rc2, rc3) == (0, 0, 0) and n_pred == n \
            and bool(np.isfinite(train["score"]))
    out["cli"] = cli
    # the card's f32 LeNet output against the CPU port's, same params
    net = load_network(os.path.join(workdir, "mnist"), device="cuda")
    cpu = load_network(os.path.join(workdir, "mnist"), device="cpu")
    x, _ = conv_data("mnist", cfg["rows"])
    got = net.output(x).cpu()
    want = cpu.output(x)
    rel = float((got - want).abs().max() / want.abs().max())
    # what a plain F.conv2d under the global flags gives at LeNet's second
    # conv, against the CPU's
    with torch.inference_mode():
        h = feed_forward(cpu.conf, cpu.params, torch.as_tensor(x))[1]
        w2 = cpu.params[2]["W"]
        plain = torch.nn.functional.conv2d(h.cuda(), w2.cuda()).cpu()
        port = conv.conv2d(h.cuda(), w2.cuda()).cpu()
        ref = torch.nn.functional.conv2d(h, w2)
    scale = float(ref.abs().max())
    out["f32_output"] = {
        "rows": cfg["rows"], "rel_err": rel,
        "conv2_rel_err_port": float((port - ref).abs().max()) / scale,
        "conv2_rel_err_global_flags": float((plain - ref).abs().max())
        / scale}
    ok &= rel <= cfg["rel_tol"] \
        and out["f32_output"]["conv2_rel_err_port"] <= cfg["rel_tol"]
    out["vgg_f32_vs_cpu"] = vgg_f32_vs_cpu(torch, cfg)
    ok &= out["vgg_f32_vs_cpu"]["ok"]
    out["deterministic_cost"] = conv_det_times(torch, cfg["det_iters"])
    # the checkpointed f32 LeNet fit: SIGTERM after 2 of 4 batches, rerun
    xs, ys = conv_data("mnist", cfg["ckpt_batch"] * cfg["ckpt_batches"])
    batches = device_batches(torch, xs, ys, cfg["ckpt_batch"])

    def fresh():
        return MultiLayerNetwork(conv_conf("lenet5", dtype=""),
                                 device="cuda", seed=0).init()

    runs = []
    for _ in range(2):
        n = fresh()
        n.fit(list(batches))
        runs.append(n)
    ck = os.path.join(workdir, "ckpt")
    first = fresh()
    first.set_listeners([SigtermAfter(cfg["ckpt_stop"])])
    try:
        first.fit(list(batches), checkpoint_dir=ck)
        interrupted = False
    except TrainingInterrupted:
        interrupted = True
    resumed = fresh()
    resumed.fit(list(batches), checkpoint_dir=ck)
    out["checkpoint"] = {
        "batches": cfg["ckpt_batches"], "batch": cfg["ckpt_batch"],
        "sigterm_after": cfg["ckpt_stop"], "interrupted": interrupted,
        "resumed_from_batch": resumed.resumed_from_batch,
        "uninterrupted_bitwise": params_gap(torch, runs[1], runs[0]),
        "resumed_vs_uninterrupted": params_gap(torch, resumed, runs[0])}
    ok &= interrupted and resumed.resumed_from_batch == cfg["ckpt_stop"] \
        and out["checkpoint"]["resumed_vs_uninterrupted"]["bitwise"]
    out["tf32_flags_after"] = {"cudnn_allow_tf32":
                               torch.backends.cudnn.allow_tf32}
    out["ok"] = bool(ok)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def phase_conv_f32(torch):
    """f32 conv nets in a child process with PyTorch's default flags
    (`conv_f32_child`); the parent checks its line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--conv-f32-child",
             td], capture_output=True, text=True, timeout=400)
    lines = proc.stdout.strip().splitlines()
    try:
        row = json.loads(lines[-1])
    except (IndexError, ValueError):
        row = {"stdout_tail": proc.stdout[-2000:]}
    row = {"phase": "conv_f32", "seconds": time.perf_counter() - t0,
           "rc": proc.returncode, **row}
    emit(row)
    check(proc.returncode == 0 and row.get("ok"),
          f"conv_f32 failed (rc {proc.returncode}): "
          f"{proc.stderr[-3000:]}")
    check(row["tf32_flags"]["cudnn_allow_tf32"],
          "the child did not run with the default (TF32) cuDNN flags")


def phase_conv_nets(torch, kernels):
    """Slice 17's conv nets (module docstring, item 15)."""
    t0 = time.perf_counter()
    profiles = {"lenet5": phase_conv_lenet(torch, kernels)}
    gc.collect()
    torch.cuda.empty_cache()
    profiles["vgg_cifar10"] = phase_conv_vgg(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    phase_conv_dropout(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    phase_conv_f32(torch)
    emit({"phase": "conv_nets", "seconds": time.perf_counter() - t0,
          "profile_by_kind_ms": {k: {p: r["by_kind_ms"]
                                     for p, r in v.items()}
                                 for k, v in profiles.items()}})


# -- slice 18: layer-wise pretraining and the classic solvers ------------------

#: where the pretraining phase runs (a CPU rehearsal sets "cpu")
PRE_DEVICE = "cuda"
#: the Curves net of Hinton & Salakhutdinov (2006): zoo.deep_autoencoder()'s
#: defaults on the Curves training set's 20,000 rows at full batch; its
#: card-vs-CPU check on a 2,000-row cut with a 5-iteration CG finetune: by
#: the 10th iteration a discrete step of the CG run parts the card from the
#: CPU port by 4.2e-5-5.0e-5 of max|leaf| from 2 of 4 initial draws (a 1e-7
#: input move does not), and the first 5 stay within 7.1e-8 from each
#: (`--seed-sweeps`, PERF.md): a long CG run is held to its first
#: iterations; `iterations` a layer's pretraining and `finetune` CG
#: iterations (the zoo's 30 and 60, cut)
PRE_AE = dict(rows=20000, cut=2000, cut_finetune=5, iterations=10,
              finetune=20)
#: the DBN of Hinton, Osindero & Teh (2006): zoo.dbn(784, [500, 500, 2000],
#: 10) on the MNIST stand-in in [0, 1], batches of 10,000
PRE_DBN = dict(hidden=(500, 500, 2000), batch=10000, train=20000,
               held_out=6000, cut=2000, cut_iterations=10, cli=20000)
#: bench.py:413-416's MLP on one 8,192-row batch, each solver
PRE_SOLVERS = dict(hidden=(512, 512), rows=8192, iterations=6,
                   hf_iterations=3, hf_cg=32, runs=2)
PRE_MIN_ACCURACY = 0.5  # chance (0.1) + 0.4
#: the card against the CPU port: within this many times the CPU's own gap
#: when its inputs move by 1e-7 relative (floor PRE_GAP_FLOOR of max|leaf|)
PRE_GAP_FACTOR, PRE_GAP_FLOOR = 10.0, 1e-6
PRE_KINDS = (("gemm", ("gemm", "cutlass", "xmma", "sm90_", "sm80_",
                       "ampere_", "Kernel2")),
             ("reduction", ("reduce", "Reduce", "norm_kernel")),
             ("threefry_int64", ("long",)),
             ("copy", ("Memcpy", "Memset", "copy_kernel")))


def pre_kind(name: str) -> str:
    for kind, keys in PRE_KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise"


def pre_sync(torch):
    if PRE_DEVICE == "cuda":
        torch.cuda.synchronize()


def pre_timed(torch, fn):
    """(fn's result, its wall ms), the device synchronised on both sides."""
    pre_sync(torch)
    t = time.perf_counter()
    out = fn()
    pre_sync(torch)
    return out, (time.perf_counter() - t) * 1e3


def pre_leaves(net):
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    return [t.detach().clone() for t in tree_leaves(net.params)]


def pre_bitwise(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def pre_gap(a, b) -> float:
    """max |a - b| over matching leaves, in units of max |b|."""
    scale = max(float(t.abs().max()) for t in b) or 1.0
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(a, b)) / scale


class PreSnapshots:
    """A listener that copies the params after each solver run (at its
    first reported iteration: listeners hear a run after it ends)."""

    def __init__(self):
        self.snaps = []

    def iteration_done(self, model, iteration, score):
        if iteration == 0:
            self.snaps.append(pre_leaves(model))


def pre_net(conf, params=None, capture=True, seed=0):
    """A network of `conf` on PRE_DEVICE (seed 0), on copies of `params`
    (leaves) where given; `capture` False runs the step cache's programs
    uncaptured."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.tree import (tree_leaves,
                                                        tree_unflatten)

    net = MultiLayerNetwork(conf, device=PRE_DEVICE, seed=seed).init()
    if params is not None:
        net.params = tree_unflatten(net.params, [
            t.detach().to(PRE_DEVICE).clone() for t in params])
        assert len(tree_leaves(net.params)) == len(params)
    net.step_cache.capture = capture
    return net


def pre_timed_layers(torch, net):
    """Wrap `net.pretrain_layer` to time each layer run (synchronised):
    returns the list it appends (layer, rows, ms) to."""
    rows = []
    real = net.pretrain_layer

    def timed(i, x):
        _, ms = pre_timed(torch, lambda: real(i, x))
        rows.append((i, int(x.shape[0]), ms))

    net.pretrain_layer = timed
    return rows


def pre_cpu_gap(torch, run, inputs):
    """The CPU port's own gap: `run(inputs)` against `run` on inputs moved
    by 1e-7 relative (a fixed random sign each), in units of max|leaf|."""
    ref = run(inputs)
    gen = torch.Generator().manual_seed(0)
    moved = [x * (1 + 1e-7 * (2 * torch.randint(0, 2, x.shape,
                                                generator=gen) - 1))
             for x in inputs]
    return pre_gap(run(moved), ref), ref


def pre_card_vs_cpu(torch, name, run, inputs, gated=True):
    """`run(inputs on a device) -> leaves` on the card and on the CPU port
    from the same params and keys: the gap, gated (unless `gated` is
    False) at PRE_GAP_FACTOR times the CPU's own gap under a 1e-7 move of
    its inputs."""
    global PRE_DEVICE
    card = run([x.to(PRE_DEVICE) for x in inputs])
    saved, PRE_DEVICE = PRE_DEVICE, "cpu"
    try:
        own, cpu = pre_cpu_gap(torch, run, [x.cpu() for x in inputs])
    finally:
        PRE_DEVICE = saved
    gap = pre_gap(card, cpu)
    gate = max(PRE_GAP_FACTOR * own, PRE_GAP_FLOOR)
    row = {"what": name, "gap_of_max_leaf": gap,
           "cpu_own_gap_1e-7": own, "gate": gate}
    check(gap <= gate or not gated, f"{name}: card {gap:.3g} from the CPU "
          f"port (gate {gate:.3g})")
    return row


def pre_curves(n):
    from deeplearning4j_tpu_torch.datasets.fetchers import CurvesDataFetcher

    return np.ascontiguousarray(CurvesDataFetcher().fetch(n).features,
                                np.float32)


def pre_ae_cut(torch, conf, x, iterations=None, seed=0, gated=True):
    """The deep AE on a cut: one layer's pretraining (layer 0, the conf's
    iterations), then an `iterations`-iteration CG finetune of the
    unrolled net (PRE_AE['cut_finetune'] by default), on the card and on
    the CPU port from the same params (the draw of `seed`)."""
    from deeplearning4j_tpu_torch.models import zoo

    start = pre_leaves(pre_net(conf, seed=seed))
    short = conf.replace(confs=conf.confs[:-1] + (conf.confs[-1].replace(
        num_iterations=iterations or PRE_AE["cut_finetune"]),))

    def pretrain(inputs):
        net = pre_net(conf, start)
        net.pretrain_layer(0, inputs[0])
        return pre_leaves(net)

    def finetune(inputs):
        net = pre_net(short, start)
        net.params = zoo.unroll_autoencoder_stack(short, net.params)
        net.finetune(inputs[0], inputs[0])
        return pre_leaves(net)

    xc = torch.from_numpy(x[:PRE_AE["cut"]])
    return [pre_card_vs_cpu(torch, "deep_ae layer 0 pretraining", pretrain,
                            [xc], gated),
            pre_card_vs_cpu(torch, "deep_ae CG finetune", finetune, [xc],
                            gated)]


def pre_deep_ae(torch, kernels, card):
    """`pretrain_deep_ae` (module docstring, item 16)."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main

    t0 = time.perf_counter()
    conf = zoo.deep_autoencoder(iterations=PRE_AE["iterations"],
                                finetune_iterations=PRE_AE["finetune"])
    x = pre_curves(PRE_AE["rows"])
    xd = torch.from_numpy(x).to(PRE_DEVICE)
    captured = pre_net(conf)
    start = pre_leaves(captured)
    uncaptured = pre_net(conf, start, capture=False)
    with torch.no_grad():
        mse0 = float(((captured.output(xd) - xd) ** 2).mean())
    runs = {}
    for name, net in (("captured", captured), ("uncaptured", uncaptured)):
        snaps = PreSnapshots()
        net.set_listeners([snaps])
        layers = pre_timed_layers(torch, net)
        real_finetune, fine = net.finetune, {}

        def finetune(a, b, net=net, real=real_finetune, snaps=snaps,
                     fine=fine):
            snaps.snaps.append(pre_leaves(net))   # after the unroll
            _, fine["ms"] = pre_timed(torch, lambda: real(a, b))
            fine["books"] = net.step_cache.stats.solver

        net.finetune = finetune
        _, wall = pre_timed(torch, lambda: zoo.fit_deep_autoencoder(net, xd))
        runs[name] = dict(snaps=snaps.snaps, layers=layers, fine=fine,
                          wall_ms=wall)
    a, b = runs["captured"], runs["uncaptured"]
    n_enc = len(conf.confs) // 2
    check(len(a["snaps"]) == len(b["snaps"]) == n_enc + 2,
          "deep_ae: a snapshot after each layer, the unroll, the finetune")
    stages = ([f"pretrain_{i}" for i in range(n_enc)]
              + ["unrolled", "finetuned"])
    bitwise = {s: pre_bitwise(torch, p, q)
               for s, p, q in zip(stages, a["snaps"], b["snaps"])}
    check(all(bitwise.values()),
          f"deep_ae: captured differs from its programs uncaptured "
          f"{bitwise}")
    with torch.no_grad():
        mse = float(((captured.output(xd) - xd) ** 2).mean())
    var = float(np.var(x))
    # JAX's criteria (MSE < 0.5 var(x), < 0.4 MSE at init) are made for
    # its test's net (one hidden layer of 64, 100 CG iterations, 120
    # rows): `pre_jax_criteria`. The Curves net at the zoo's defaults
    # misses them in both packages (JAX's own CPU run on 2,000 rows: MSE
    # 0.01536, var 0.01618): here it must improve on its init.
    check(np.isfinite(mse) and mse < mse0,
          f"deep_ae: reconstruction MSE {mse} (var {var}, at init {mse0})")
    # replays, timed: each layer's captured run once more on its input
    # from the trained net, and the CG finetune again from the unrolled
    # params (the recipe's first runs include their captures)
    from deeplearning4j_tpu_torch.nn.multilayer import feed_forward
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    iters = conf.confs[0].num_iterations
    cg_first_ms = {name: r["fine"]["ms"] for name, r in runs.items()}
    for i in range(n_enc):
        with torch.no_grad():
            acts = feed_forward(conf, captured.params, xd, up_to=i)
        captured.pretrain_layer(i, acts[-1] if acts else xd)
    replay_layer_ms = [ms for _, _, ms in a["layers"][n_enc:]]

    def unrolled():
        with torch.no_grad():
            for t, s in zip(tree_leaves(captured.params), a["snaps"][n_enc]):
                t.copy_(s)

    unrolled()
    captured.finetune(xd, xd)
    books = a["fine"]["books"]
    probes = books["probes"]
    cg_replay_ms = a["fine"]["ms"]
    check(books["graphs_captured"] == 0, "deep_ae: the CG replay captured")
    row = {"phase": "pretrain_deep_ae", "gpu": card,
           "widths": [c.n_out for c in conf.confs[:n_enc]],
           "params": sum(t.numel() for t in start),
           "rows": PRE_AE["rows"], "mse": mse, "mse_at_init": mse0,
           "var": var, "mse_over_var": mse / var, "bitwise": bitwise,
           "jax_criteria": pre_jax_criteria(torch),
           "first_run_layer_ms": {name: [ms for _, _, ms in
                                         r["layers"][:n_enc]]
                                  for name, r in runs.items()},
           "replay_layer_ms": replay_layer_ms,
           "replay_ms_per_iteration": [ms / iters for ms in replay_layer_ms],
           "uncaptured_ms_per_iteration": [ms / iters for _, _, ms in
                                           b["layers"]],
           "cg_first_run_ms": cg_first_ms,
           "cg_replay_ms": cg_replay_ms,
           "cg_iterations_run": books["iterations_run"],
           "cg_ms_per_iteration": cg_replay_ms / max(1, len(probes)),
           "probes_per_iteration": {"mean": float(np.mean(probes)),
                                    "max": int(max(probes))},
           "host_syncs_per_iteration": {
               "mean": books["host_reads"] / max(1, len(probes)),
               "max": int(max(probes))},
           "graphs_per_cg_run": len(getattr(next(
               p for k, p in captured.step_cache._programs.items()
               if k[0] == "finetune"), "graphs", {})),
           "capture_s": captured.step_cache.stats.total_compile_seconds,
           "graph_pool_bytes": captured.step_cache.pool.reserved_bytes,
           "wall_ms": {name: r["wall_ms"] for name, r in runs.items()}}
    # one profiled pretrain run of layer 0 and one CG run
    # from the unrolled params
    prof_pre = conv_profile(
        torch, kernels, lambda: captured.pretrain_layer(0, xd),
        "pretrain_deep_ae_profile_layer0", kind=pre_kind)
    unrolled()
    prof_cg = conv_profile(
        torch, kernels, lambda: captured.finetune(xd, xd),
        "pretrain_deep_ae_profile_cg", kind=pre_kind)
    cg_iters = captured.step_cache.stats.solver["iterations_run"]
    row["profile"] = {
        "pretrain_iteration_by_kind_ms": {
            k: v / iters for k, v in prof_pre["by_kind_ms"].items()},
        "pretrain_draw_share": prof_pre["by_kind_ms"].get(
            "threefry_int64", 0.0) / prof_pre["device_ms"],
        "pretrain_idle_share": prof_pre["idle_share"],
        "cg_iteration_by_kind_ms": {
            k: v / max(1, cg_iters) for k, v in prof_cg["by_kind_ms"].items()},
        "cg_idle_share": prof_cg["idle_share"]}
    row["card_vs_cpu"] = pre_ae_cut(torch, conf, x)
    # the CLI recipe at the zoo's widths
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    # the CLI's network: the conf's own seed
    init = MultiLayerNetwork(conf, device=PRE_DEVICE).init()
    score0 = init.score(xd, xd)
    del init
    with tempfile_dir() as td:
        rc, out = cli_json(cli_main, [
            "train", "--zoo", "deep_autoencoder:hidden=400x200x100x50x25x6,"
            f"iterations={PRE_AE['iterations']},"
            f"finetune={PRE_AE['finetune']}", "--input",
            f"curves:{PRE_AE['rows']}",
            "--output", os.path.join(td, "dae")])
    check(rc == 0 and np.isfinite(out["score"]) and out["score"] < score0,
          f"deep_ae CLI: rc {rc}, score {out.get('score')} (init {score0})")
    row["cli"] = {"score": out["score"], "score_at_init": score0,
                  "train_seconds": out["train_seconds"],
                  "capture_seconds": out["compile_seconds"]}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def pre_jax_criteria(torch) -> dict:
    """JAX's deep-AE test on the card (tests/test_multilayer.py:154-187):
    `deep_autoencoder(784, hidden=(64,), iterations=20,
    finetune_iterations=100, lr=0.1)` on 120 curves through
    `fit_deep_autoencoder`: MSE < 0.5 var(x) and < 0.4 MSE at init."""
    from deeplearning4j_tpu_torch.models import zoo

    x = torch.from_numpy(pre_curves(120)).to(PRE_DEVICE)
    net = pre_net(zoo.deep_autoencoder(784, hidden=(64,), iterations=20,
                                       finetune_iterations=100, lr=0.1),
                  seed=1)
    with torch.no_grad():
        mse0 = float(((net.output(x) - x) ** 2).mean())
    zoo.fit_deep_autoencoder(net, x)
    with torch.no_grad():
        mse = float(((net.output(x) - x) ** 2).mean())
    var = float(x.var(unbiased=False))
    check(mse < 0.5 * var and mse < 0.4 * mse0,
          f"deep_ae (JAX's test net): MSE {mse} (var {var}, init {mse0})")
    return {"mse": mse, "var": var, "mse_at_init": mse0}


class tempfile_dir:
    """A temporary directory, removed on exit."""

    def __enter__(self):
        import tempfile

        self.td = tempfile.TemporaryDirectory()
        return self.td.name

    def __exit__(self, *exc):
        self.td.cleanup()


def pre_mnist01(n):
    """The MNIST stand-in scaled into [0, 1] (the CLI's --scale-01)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    x, y = conv_data("mnist", n)
    ds = DataSet(x, y).scale_to_unit()
    return (np.ascontiguousarray(ds.features, np.float32),
            np.ascontiguousarray(ds.labels, np.float32))


def pre_rbm_draws(torch, net, x):
    """The card's uniforms for layer 0's first Gibbs step (bitwise the
    CPU's), and the flips of its hidden sample against the CPU port's from
    the same params, beside the draws that lie within 1e-6 of p."""
    from deeplearning4j_tpu_torch.nd import random as nd_random

    key = nd_random.fold_in(torch.tensor([7, 11], dtype=torch.int64), 0)
    W, b = (net.params[0][k] for k in ("W", "b"))
    n = x.shape[0] * W.shape[1]
    u_card = nd_random.uniform(key.to(PRE_DEVICE), n)
    u_cpu = nd_random.uniform(key, n)
    same = bool(torch.equal(u_card.cpu(), u_cpu))
    check(same, "the card's threefry uniforms differ from the CPU's")
    with torch.no_grad():
        p_card = torch.sigmoid(x @ W + b)
        p_cpu = torch.sigmoid(x.cpu() @ W.cpu() + b.cpu())
    s_card = nd_random.bernoulli(key.to(PRE_DEVICE), p_card).cpu()
    s_cpu = nd_random.bernoulli(key, p_cpu)
    flips = int((s_card != s_cpu).sum())
    near = int(((u_cpu.reshape(p_cpu.shape) - p_cpu).abs() < 1e-6).sum())
    check(flips <= near, f"{flips} flips but {near} near-ties")
    return {"uniforms": n, "uniforms_bitwise": same, "flips": flips,
            "draws_within_1e-6_of_p": near,
            "p_max_abs_diff": float((p_card.cpu() - p_cpu).abs().max())}


def pre_dbn_cut(torch, conf, x, y):
    """Layer 0's pretraining (PRE_DBN["cut_iterations"] CD-1 iterations)
    on a cut, card against the CPU port from the same params and key."""
    conf = conf.replace(confs=(conf.confs[0].replace(
        num_iterations=PRE_DBN["cut_iterations"]),) + conf.confs[1:])
    start = pre_leaves(pre_net(conf))

    def pretrain(inputs):
        net = pre_net(conf, start)
        net.pretrain_layer(0, inputs[0])
        return pre_leaves(net)

    return pre_card_vs_cpu(torch, "dbn RBM 0 pretraining (CD-1)", pretrain,
                           [torch.from_numpy(x[:PRE_DBN["cut"]])])


def pre_dbn(torch, kernels, card):
    """`pretrain_dbn` (module docstring, item 16)."""
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.models import zoo

    t0 = time.perf_counter()
    n_train, bsz = PRE_DBN["train"], PRE_DBN["batch"]
    x, y = pre_mnist01(n_train + PRE_DBN["held_out"])
    conf = zoo.dbn(x.shape[1], list(PRE_DBN["hidden"]), y.shape[1])
    xd = torch.from_numpy(x).to(PRE_DEVICE)
    yd = torch.from_numpy(y).to(PRE_DEVICE)
    batches = [(xd[i:min(i + bsz, n_train)], yd[i:min(i + bsz, n_train)])
               for i in range(0, n_train, bsz)]
    net = pre_net(conf)
    start = pre_leaves(net)
    # batch 1 captured against its programs uncaptured
    twin = pre_net(conf, start, capture=False)
    layers = pre_timed_layers(torch, net)
    fine = []
    real_finetune = net.finetune

    def finetune(a, b):
        _, ms = pre_timed(torch, lambda: real_finetune(a, b))
        fine.append((ms, net.step_cache.stats.solver))

    net.finetune = finetune
    batch_ms = []
    for i, (xb, yb) in enumerate(batches):
        _, ms = pre_timed(torch, lambda: net.fit(xb, yb))
        batch_ms.append(ms)
        if i == 0:
            first = pre_leaves(net)
            _, twin_ms = pre_timed(torch, lambda: twin.fit(xb, yb))
            bitwise = pre_bitwise(torch, first, pre_leaves(twin))
            check(bitwise, "dbn: batch 1 captured differs from its "
                  "programs uncaptured")
    del twin
    held_x, held_y = xd[n_train:], yd[n_train:]
    acc = float((net.output(held_x).argmax(1) == held_y.argmax(1))
                .float().mean())
    check(acc >= PRE_MIN_ACCURACY, f"dbn held-out accuracy {acc}")
    # replays of the full batches (batch 1 captured; the tail its own)
    rep = [(i, r, ms) for i, r, ms in layers[len(PRE_DBN["hidden"]):]
           if r == bsz]
    iters = conf.confs[0].num_iterations
    per_layer = {f"rbm{i}": median([ms for j, _, ms in rep if j == i]) / iters
                 for i in range(len(PRE_DBN["hidden"]))}
    probes = [p for _, books in fine for p in books["probes"]]
    row = {"phase": "pretrain_dbn", "gpu": card,
           "widths": [x.shape[1], *PRE_DBN["hidden"], y.shape[1]],
           "params": sum(t.numel() for t in start),
           "batches": [int(b[0].shape[0]) for b in batches],
           "batch_ms": batch_ms, "batch1_uncaptured_ms": twin_ms,
           "batch1_bitwise": bitwise, "held_out_accuracy": acc,
           "pretrain_ms_per_iteration": per_layer,
           "cg_ms": [ms for ms, _ in fine],
           "cg_probes_per_iteration": {"mean": float(np.mean(probes)),
                                       "max": int(max(probes))},
           "capture_s": net.step_cache.stats.total_compile_seconds,
           "graph_pool_bytes": net.step_cache.pool.reserved_bytes,
           "step_cache": net.step_cache.stats.as_dict()}
    row["draws"] = pre_rbm_draws(torch, net, batches[0][0])
    # one profiled 2000-wide RBM run (30 CD-1 iterations) and one batch
    with torch.no_grad():
        from deeplearning4j_tpu_torch.nn.multilayer import feed_forward

        acts = feed_forward(conf, net.params, batches[0][0], up_to=2)[-1]
    prof = conv_profile(torch, kernels, lambda: net.pretrain_layer(2, acts),
                        "pretrain_dbn_profile_rbm2", kind=pre_kind)
    draw = prof["by_kind_ms"].get("threefry_int64", 0.0)
    row["profile_rbm2"] = {
        "iteration_by_kind_ms": {k: v / iters
                                 for k, v in prof["by_kind_ms"].items()},
        "draw_share": draw / prof["device_ms"],
        "idle_share": prof["idle_share"]}
    prof_b = conv_profile(torch, kernels, lambda: net.fit(*batches[1]),
                          "pretrain_dbn_profile_batch", kind=pre_kind)
    row["profile_batch"] = {"device_ms": prof_b["device_ms"],
                            "wall_ms": prof_b["wall_ms"],
                            "idle_share": prof_b["idle_share"],
                            "draw_share": prof_b["by_kind_ms"].get(
                                "threefry_int64", 0.0) / prof_b["device_ms"]}
    row["card_vs_cpu"] = pre_dbn_cut(torch, conf, x, y)
    with tempfile_dir() as td:
        rc, out = cli_json(cli_main, [
            "train", "--zoo", "dbn:hidden=500x500x2000", "--input",
            f"mnist:{PRE_DBN['cli']}", "--scale-01",
            "--properties", f"batch={bsz}",
            "--output", os.path.join(td, "dbn")])
    check(rc == 0 and np.isfinite(out["score"]),
          f"dbn CLI: rc {rc}, {out}")
    row["cli"] = {"score": out["score"], "train_seconds": out["train_seconds"],
                  "capture_seconds": out["compile_seconds"],
                  "examples_per_sec": out["examples_per_sec"]}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def pre_gn_dense(torch):
    """A Gauss-Newton product on the card against dense M'Mv
    (tests/test_hessian_free.py:36-49's shape), within 1e-4."""
    from deeplearning4j_tpu_torch.optimize import solver

    gen = torch.Generator().manual_seed(1)
    M = torch.randn(5, 4, generator=gen).to(PRE_DEVICE)
    y = torch.randn(5, generator=gen).to(PRE_DEVICE)
    v = torch.randn(4, generator=gen).to(PRE_DEVICE)
    obj = solver.from_predict_loss(lambda p, k: M @ p,
                                   lambda z: 0.5 * torch.sum((z - y) ** 2))
    gv = obj.gnvp(torch.zeros(4, device=PRE_DEVICE), v, None)
    err = float((gv - M.T @ (M @ v)).abs().max())
    check(err <= 1e-4, f"Gauss-Newton product {err} from dense M'Mv")
    return err


def pre_solvers(torch, kernels, card):
    """`solvers` (module docstring, item 16)."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import make_finetune_loss
    from deeplearning4j_tpu_torch.optimize import linesearch, solver
    from deeplearning4j_tpu_torch.optimize.step_cache import _Graph
    from deeplearning4j_tpu_torch.optimize.tree import tree_unflatten

    t0 = time.perf_counter()
    cfg = PRE_SOLVERS
    x, y = conv_data("mnist", cfg["rows"])
    xd = torch.from_numpy(x).to(PRE_DEVICE)
    yd = torch.from_numpy(y).to(PRE_DEVICE)
    base = zoo.mlp(x.shape[1], list(cfg["hidden"]), y.shape[1])
    rows = {}
    for algo in ("gradient_descent", "conjugate_gradient", "lbfgs",
                 "hessian_free"):
        hf = algo == "hessian_free"
        conf = base.replace(confs=tuple(c.replace(
            optimization_algo=algo, hf_cg_iterations=cfg["hf_cg"],
            num_iterations=cfg["hf_iterations" if hf else "iterations"])
            for c in base.confs))
        net = pre_net(conf)
        start = pre_leaves(net)
        twin = pre_net(conf, start, capture=False)
        scores, ms, books = [], [], []
        for r in range(cfg["runs"]):
            # each run from the same params: the graphs read them in place
            with torch.no_grad():
                for t, s in zip(pre_leaves_refs(net), start):
                    t.copy_(s)
            rec = ScoreRec()
            net.set_listeners([rec])
            _, t_ms = pre_timed(torch, lambda: net.finetune(xd, yd))
            scores.append(rec.scores)
            ms.append(t_ms)
            books.append(net.step_cache.stats.solver)
        twin.finetune(xd, yd)
        bitwise = pre_bitwise(torch, pre_leaves(net), pre_leaves(twin))
        check(bitwise, f"{algo}: captured differs from its program "
              f"uncaptured")
        check(scores[0][-1] < scores[0][0], f"{algo}: scores did not fall "
              f"{scores[0]}")
        row = {"iterations": conf.confs[-1].num_iterations,
               "run_ms": ms, "ms_per_run": median(ms[1:]),
               "bitwise_vs_uncaptured": bitwise,
               "first_score": scores[0][0], "last_score": scores[0][-1],
               "capture_s": net.step_cache.stats.total_compile_seconds,
               "graph_pool_bytes": net.step_cache.pool.reserved_bytes}
        if hf:
            progs = list(net.step_cache._programs.values())
            check(len(progs) == 1 and isinstance(progs[0], _Graph)
                  and net.step_cache.stats.misses == 1,
                  "hessian_free is not one graph a run")
            row["graphs_per_run"] = 1
            row["ms_per_iteration"] = row["ms_per_run"] / row["iterations"]
        else:
            # the eager form on the same row-weighted loss, its backtrack's
            # score calls counted per iteration
            loss = make_finetune_loss(conf)
            w = torch.ones(cfg["rows"], device=PRE_DEVICE)
            objective = solver.from_loss_with_aux(
                lambda p, k: loss(p, xd, yd, w, k))
            counts, real = [], linesearch.backtrack

            def counting(score_fn, *a, **kw):
                n = [0]

                def counted(v):
                    n[0] += 1
                    return score_fn(v)

                out = real(counted, *a, **kw)
                counts.append(n[0])
                return out

            linesearch.backtrack = counting
            try:
                solver._line_searched(objective, tree_unflatten(
                    net.params, [t.clone() for t in start]),
                    conf.confs[-1], None)
            finally:
                linesearch.backtrack = real
            probes = books[-1]["probes"]
            check(probes == counts, f"{algo}: probes {probes} against the "
                  f"eager backtrack's {counts}")
            row.update(probes_per_iteration=probes,
                       graphs=books[0]["graphs_captured"],
                       replays_per_run=books[-1]["graph_replays"],
                       host_reads_per_run=books[-1]["host_reads"],
                       ms_per_iteration=row["ms_per_run"] / max(1,
                                                                len(probes)))
        rows[algo] = row
        del net, twin
    out = {"phase": "solvers", "gpu": card,
           "widths": [x.shape[1], *cfg["hidden"], y.shape[1]],
           "rows": cfg["rows"], "gauss_newton_max_err": pre_gn_dense(torch),
           "solvers": rows, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def pre_leaves_refs(net):
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    return tree_leaves(net.params)


class ScoreRec:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(score)


def phase_pretraining(torch, kernels):
    """Slice 18's pretraining and solvers (module docstring, item 16)."""
    t0 = time.perf_counter()
    card = gpu_line()
    ae = pre_deep_ae(torch, kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    dbn = pre_dbn(torch, kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    sol = pre_solvers(torch, kernels, card)
    emit({"phase": "pretraining", "gpu": card,
          "seconds": time.perf_counter() - t0,
          "parts_seconds": {"pretrain_deep_ae": ae["seconds"],
                            "pretrain_dbn": dbn["seconds"],
                            "solvers": sol["seconds"]}})


# -- slice 19: data-parallel training ------------------------------------------

#: the flagship through `DataParallelTrainer` at bench.py:546-569's conf (the
#: train phase's `train_conf`, TRAIN_LR), batch `rows` x 512 ids from
#: RandomState(0): `steps` eager, then `steps` captured trainer steps (each
#: held bitwise to the eager one), `timed` event-timed captured steps and as
#: many `fit` steps, one profiled step, `zero1_steps` ZeRO-1 steps
DP = dict(rows=32, steps=2, timed=3, zero1_steps=2)
#: the SIGTERM child: the flagship's widths at `blocks` blocks, `batches`
#: batches of `rows` rows, stopped after `stop`
DP_CKPT = dict(blocks=2, rows=8, batches=4, stop=2)
#: the bench's char-LSTM (bench.py:249-263: LSTM's widths, batch 256 x 64)
#: and VGG-CIFAR10 (bench.py:319-328: width 64, batch 512, the CIFAR
#: stand-in) through the trainer
DP_LSTM = dict(steps=2, timed=3)
DP_VGG = dict(width=64, batch=512, steps=2, timed=3)
#: a trainer step against one `fit` call (bf16 compute, where the two take
#: the loss's mean in another order), and the BatchNorm EMA likewise: the
#: gap may be a hundredth of how far that step moved the leaves, so a
#: skipped or wrong-signed update fails
DP_STEP_TOL = 1e-2
#: the flash kernels' bf16 bodies, as the profiler names them, by row
DP_FLASH = {"flash_attn_fwd": "flash_fwd_tma_kernel",
            "flash_bwd_delta": "flash_bwd_delta_kernel",
            "flash_bwd_dkv": "flash_bwd_dkv_tma_kernel",
            "flash_bwd_dq": "flash_bwd_dq_tma_kernel"}
DP_KINDS = (("nccl", ("nccl",)), ("attention", ("flash_",)),
            ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "sm80_",
                      "cublas")),
            ("copy_cast", ("copy", "cast", "convert")),
            ("reduction", ("reduce",)),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))


def dp_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in DP_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def dp_net(conf):
    """A network of `conf` on the card at seed 0 (the same params every
    time)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(conf, device="cuda", seed=0).init()


def dp_free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def dp_snapshot(trainer):
    """The trainer's params and whole updater as named host copies."""
    params, updater, _ = trainer.checkpoint_state()
    out = [(f"params/{i}.{k}", t.detach().to("cpu", copy=True))
           for i, layer in enumerate(params) for k, t in sorted(layer.items())]
    for field, tree in zip(("hist", "vel"), updater):
        out += [(f"{field}/{i}.{k}", t.detach().to("cpu", copy=True))
                for i, layer in enumerate(tree)
                for k, t in sorted(layer.items())]
    return out


def dp_gap(torch, got, want) -> dict:
    """Bitwise, the first leaf that differs, max |got - want| and max
    |want| over named leaves."""
    first = next((n for (n, a), (_, b) in zip(got, want)
                  if not torch.equal(a, b)), None)
    return {"bitwise": first is None, "first_differing_leaf": first,
            "max_abs_diff": max(float((a.float() - b.float()).abs().max())
                                for (_, a), (_, b) in zip(got, want)),
            "max_abs": max(float(b.float().abs().max()) for _, b in want)}


def dp_profile(torch, kernels, fn, phase, quiet=False) -> dict:
    """One fn() call under `torch.profiler`: device ms by kind (DP_KINDS),
    the calls of each flash kernel body, the NCCL kernels' ms, the largest
    kernels and the wall time (emitted unless `quiet`). Launches made here
    are not counted."""
    from torch.profiler import ProfilerActivity, profile

    saved = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels.LAUNCHES.update(saved)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    by_kind = {}
    for e in events:
        by_kind[dp_kind(e.key)] = (by_kind.get(dp_kind(e.key), 0.0)
                                   + e.device_time_total / 1e3)
    total_ms = sum(e.device_time_total for e in events) / 1e3
    row = {"phase": phase, "wall_ms": wall_ms, "device_ms": total_ms,
           "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
           "flash_calls": {row: sum(e.count for e in events if body in e.key)
                           for row, body in DP_FLASH.items()},
           "nccl": [{"name": e.key[:90], "calls": e.count,
                     "ms": e.device_time_total / 1e3}
                    for e in events if "nccl" in e.key.lower()],
           "kernel_count": sum(e.count for e in events),
           "top": [{"name": e.key[:90], "kind": dp_kind(e.key),
                    "calls": e.count, "ms": e.device_time_total / 1e3}
                   for e in events[:12]]}
    if not quiet:
        emit(row)
    return row


def dp_turns(torch, kernels, make, x, y, steps):
    """`steps` `fit` calls of an eager trainer (its cache's capture off),
    its state snapshotted after each, then of a captured one on the same
    params, each held to the eager state of its step. Returns (captured
    trainer, per-step gaps, the captured steps' launches, eager step ms,
    captured step ms)."""
    eager = make()
    eager.compile_cache.capture = False
    snaps, eager_ms = [], []
    for _ in range(steps):
        eager_ms.append(event_ms(torch, lambda: eager.fit([(x, y)])))
        snaps.append(dp_snapshot(eager))
    del eager
    dp_free(torch)
    trainer = make()
    gaps, launches, cap_ms = [], [], []
    for snap in snaps:
        kernels.reset_launches()
        cap_ms.append(event_ms(torch, lambda: trainer.fit([(x, y)])))
        launches.append(dict(kernels.LAUNCHES))
        gaps.append(dp_gap(torch, dp_snapshot(trainer), snap))
    return trainer, gaps, launches, eager_ms, cap_ms, snaps


def dp_step_times(torch, trainer, x, y, n):
    """n captured steps as bench.py drives them (`trainer._step` on the
    sharded batch, one key), each event-timed."""
    from deeplearning4j_tpu_torch.parallel.mesh import shard_batch

    xs, ys = shard_batch(trainer.mesh, (x, y), trainer.axis)
    key = trainer._next_key()

    def step():
        trainer.state, _ = trainer._step(trainer.state, xs, ys, key,
                                         checked=True)

    return [event_ms(torch, step) for _ in range(n)], step


def dp_books(trainer) -> dict:
    cache = trainer.compile_cache
    return {"capture_s": cache.stats.total_compile_seconds,
            "graph_pool_bytes": cache.pool.reserved_bytes,
            "dp_step_cache": cache.stats.as_dict()}


def dp_flagship(torch, kernels, card):
    """The flagship through the trainer (module docstring, item 17)."""
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        CAPTURED_COLLECTIVES, DataParallelTrainer)
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    cfg = DP
    vocab, seq, rows = SLICE["vocab"], SLICE["seq"], cfg["rows"]
    mesh = make_mesh({"dp": 1}, device="cuda")
    conf = train_conf("bfloat16")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (rows, seq + 1))
    x = ids[:, :-1].astype(np.int32)
    y = ids[:, 1:].reshape(rows * seq).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # one `fit` call (its captured step), then its timed steps
    ref = dp_net(conf)

    def ref_params():
        return [(f"params/{i}.{k}", t.detach().to("cpu", copy=True))
                for i, layer in enumerate(ref.params)
                for k, t in sorted(layer.items())]

    init_params = ref_params()
    ref.fit(x, y)
    fit_params = ref_params()
    # how far one step moved the params: the scale of step 1's gate
    moved = dp_gap(torch, fit_params, init_params)["max_abs_diff"]
    del init_params
    fit_ms = [event_ms(torch, lambda: ref.fit(x, y))
              for _ in range(cfg["timed"])]
    del ref
    dp_free(torch)

    def make():
        return DataParallelTrainer(dp_net(conf), mesh, mode="sync")

    before = dict(CAPTURED_COLLECTIVES)
    trainer, gaps, launches, eager_ms, cap_ms, snaps = dp_turns(
        torch, kernels, make, x, y, cfg["steps"])
    captured = {k: v - before[k] for k, v in CAPTURED_COLLECTIVES.items()}
    step1 = dp_gap(torch, snaps[0][:len(fit_params)], fit_params)
    step_ms, step = dp_step_times(torch, trainer, x, y, cfg["timed"])
    books = dp_books(trainer)
    profile = dp_profile(torch, kernels, step, "data_parallel_profile")
    median_ms = median(step_ms)
    params = sum(t.numel() for t in tree_leaves(trainer.state.params))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del trainer
    dp_free(torch)
    # ZeRO-1 at world size 1: held bitwise to the sync step
    z = DataParallelTrainer(dp_net(conf), mesh, mode="sync", zero1=True)
    before = dict(CAPTURED_COLLECTIVES)
    z_ms = [event_ms(torch, lambda: z.fit([(x, y)]))
            for _ in range(cfg["zero1_steps"])]
    z_captured = {k: v - before[k] for k, v in CAPTURED_COLLECTIVES.items()}
    zero1 = dp_gap(torch, dp_snapshot(z), snaps[cfg["zero1_steps"] - 1])
    z_books = dp_books(z)
    del z, snaps
    dp_free(torch)
    n_attn = SLICE["n_blocks"]
    row = {"phase": "data_parallel_flagship", "gpu": card,
           "config": SLICE, "rows": rows, "tokens_per_step": rows * seq,
           "params": params, "mode": "sync", "world_size": 1,
           "backend": mesh.backend, "lr": TRAIN_LR,
           "step_ms": step_ms, "step_ms_median": median_ms,
           "tokens_per_s": rows * seq / (median_ms / 1e3),
           "fit_step_ms": fit_ms, "fit_step_ms_median": median(fit_ms),
           "fit_steps": cfg["timed"] + 1,
           "trainer_fit_ms": {"eager": eager_ms, "captured": cap_ms},
           "captured_vs_eager": gaps,
           "step1_vs_fit": {**step1, "step_max_abs": moved,
                            "tol": DP_STEP_TOL * moved},
           "zero1_vs_sync": {**zero1, "steps": cfg["zero1_steps"],
                             "fit_ms": z_ms, "graph": z_books,
                             "collectives_in_graph": z_captured},
           # collectives issued inside the step's capture (the gradient
           # buffer's all-reduce and the score's)
           "collectives_in_graph": captured,
           "launches_per_step": launches, "graph": books,
           "peak_mem_gb": peak_gb,
           "masked_steps": "not run on the card: at world size 1 every "
                           "batch divides; held on the CPU at world size 2 "
                           "(tests/test_torch_dp_ranks.py)",
           "seconds": time.perf_counter() - t0}
    nccl_ms = sum(r["ms"] for r in profile["nccl"])
    row.update({"device_ms": profile["device_ms"],
                # the profiled replay's own: its device time over its wall
                # time (which holds the profiler's cost: an upper bound)
                "idle_share": 1.0 - profile["device_ms"] / profile["wall_ms"],
                "by_kind_ms": profile["by_kind_ms"],
                # NCCL's in-place all-reduce of one rank launches no
                # kernel: 0 at world size 1
                "nccl_ms": nccl_ms,
                "nccl_share": nccl_ms / profile["device_ms"],
                "flash_calls_in_replay": profile["flash_calls"]})
    emit(row)
    for i, gap in enumerate(gaps):
        check(gap["bitwise"], f"data_parallel: captured trainer step {i + 1}"
              f" differs from the eager one: {gap}")
    check(moved > 0 and (step1["bitwise"] or step1["max_abs_diff"]
                         <= DP_STEP_TOL * moved),
          f"data_parallel: step 1 against fit (fit moved the params by "
          f"{moved}): {step1}")
    check(zero1["bitwise"], f"data_parallel: ZeRO-1 differs from sync after "
          f"{cfg['zero1_steps']} steps: {zero1}")
    for launch in launches:
        for name in DP_FLASH:
            check(launch[name] == n_attn,
                  f"data_parallel: a step launched {name} {launch[name]} "
                  f"times, want {n_attn}: {launch}")
    check(books["dp_step_cache"]["misses"] == 1,
          f"data_parallel: captured under traffic after warm-up: {books}")
    for name, calls in profile["flash_calls"].items():
        check(calls == n_attn, f"data_parallel: the profiled replay ran "
              f"{name} {calls} times, want {n_attn}")
    check(captured["all_reduce"] >= 2 and z_captured["reduce_scatter"]
          >= 1 and z_captured["all_gather"] >= 1,
          f"data_parallel: the collectives are not inside the captured "
          f"steps: sync {captured}, zero1 {z_captured}")
    return {name: sum(launch[name] for launch in launches)
            for name in DP_FLASH}


def dp_lstm(torch, kernels, card):
    """The bench's char-LSTM through the trainer: captured against eager
    bitwise, the cell kernel's launches a step, step ms."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        DataParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh({"dp": 1}, device="cuda")
    conf = lstm_conf()
    x, y = lstm_batch()

    def make():
        return DataParallelTrainer(dp_net(conf), mesh)

    trainer, gaps, launches, eager_ms, cap_ms, _ = dp_turns(
        torch, kernels, make, x, y, DP_LSTM["steps"])
    step_ms, _ = dp_step_times(torch, trainer, x, y, DP_LSTM["timed"])
    books = dp_books(trainer)
    want = LSTM["n_layers"] * LSTM["seq"]
    row = {"phase": "data_parallel_char_lstm", "gpu": card,
           "config": LSTM, "step_ms": step_ms,
           "step_ms_median": median(step_ms),
           "chars_per_s": LSTM["rows"] * LSTM["seq"]
           / (median(step_ms) / 1e3),
           "trainer_fit_ms": {"eager": eager_ms, "captured": cap_ms},
           "captured_vs_eager": gaps, "launches_per_step": launches,
           "graph": books, "seconds": time.perf_counter() - t0}
    emit(row)
    for i, gap in enumerate(gaps):
        check(gap["bitwise"], f"data_parallel char-LSTM: captured step "
              f"{i + 1} differs from the eager one: {gap}")
    for launch in launches:
        check(launch["lstm_cell"] == want,
              f"data_parallel char-LSTM: a step launched the cell "
              f"kernel {launch['lstm_cell']} times, want {want}")
    check(books["dp_step_cache"]["misses"] == 1,
          f"data_parallel char-LSTM: captured under traffic: {books}")
    return sum(launch["lstm_cell"] for launch in launches)


def dp_vgg(torch, kernels, card):
    """VGG-CIFAR10 through the trainer: captured against eager bitwise, its
    BatchNorm EMA after one step against one `fit` call's, step ms."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        DataParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    cfg = DP_VGG
    mesh = make_mesh({"dp": 1}, device="cuda")
    conf = conv_conf("vgg_cifar10", width=cfg["width"])
    x, y = conv_data("cifar10", cfg["batch"])
    ref = dp_net(conf)

    def ref_ema():
        return [(n, t.detach().to("cpu", copy=True))
                for n, t in named_leaves(ref, True)]

    init_ema = ref_ema()
    ref.fit(x, y)
    fit_ema = ref_ema()
    # how far one step moved the EMA: the scale of its gate
    moved = dp_gap(torch, fit_ema, init_ema)["max_abs_diff"]
    del ref
    dp_free(torch)

    def make():
        return DataParallelTrainer(dp_net(conf), mesh)

    trainer, gaps, launches, eager_ms, cap_ms, snaps = dp_turns(
        torch, kernels, make, x, y, cfg["steps"])
    ema_names = {f"params/{n}" for n, _ in fit_ema}
    step1_ema = [(n, t) for n, t in snaps[0] if n in ema_names]
    ema = dp_gap(torch, step1_ema, [(f"params/{n}", t) for n, t in fit_ema])
    step_ms, _ = dp_step_times(torch, trainer, x, y, cfg["timed"])
    books = dp_books(trainer)
    sharded_async = dp_sharded_async(torch, trainer)
    row = {"phase": "data_parallel_vgg", "gpu": card, "width": cfg["width"],
           "batch": cfg["batch"], "step_ms": step_ms,
           "step_ms_median": median(step_ms),
           "samples_per_s": cfg["batch"] / (median(step_ms) / 1e3),
           "trainer_fit_ms": {"eager": eager_ms, "captured": cap_ms},
           "captured_vs_eager": gaps,
           "ema_step1_vs_fit": {**ema, "step_max_abs": moved,
                                "tol": DP_STEP_TOL * moved},
           "graph": books, "sharded_async": sharded_async,
           "seconds": time.perf_counter() - t0}
    emit(row)
    check(sharded_async["bitwise"] and sharded_async["leaves"] > 0,
          f"data_parallel VGG: the save_sharded_async checkpoint differs "
          f"from save_sharded's: {sharded_async}")
    for i, gap in enumerate(gaps):
        check(gap["bitwise"], f"data_parallel VGG: captured step {i + 1} "
              f"differs from the eager one: {gap}")
    check(len(step1_ema) == len(fit_ema) > 0 and moved > 0 and (
        ema["bitwise"] or ema["max_abs_diff"] <= DP_STEP_TOL * moved),
          f"data_parallel VGG: the EMA after one step differs from fit's "
          f"(fit moved it by {moved}): {ema}")
    check(books["dp_step_cache"]["misses"] == 1,
          f"data_parallel VGG: captured under traffic: {books}")


def dp_sharded_async(torch, trainer) -> dict:
    """The trainer's state (params and updater, on the card) written by
    `save_sharded_async`, then `join_async`, against `save_sharded` of the
    same state: both loaded back, every leaf bitwise equal. The params are
    changed between the async call and the join (and put back after),
    which the async checkpoint must not see."""
    import tempfile

    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
    from deeplearning4j_tpu_torch.parallel import checkpoint

    st = trainer.state
    with tempfile.TemporaryDirectory() as td:
        sync, lazy = os.path.join(td, "sync"), os.path.join(td, "async")
        t = time.perf_counter()
        checkpoint.save_sharded(sync, st.params, st.updater, step=st.step)
        sync_s = time.perf_counter() - t
        t = time.perf_counter()
        checkpoint.save_sharded_async(lazy, st.params, st.updater,
                                      step=st.step)
        call_s = time.perf_counter() - t
        kept = [leaf.clone() for leaf in tree_leaves(st.params)]
        for leaf in tree_leaves(st.params):
            leaf.add_(1.0)  # after the call: not in the checkpoint
        checkpoint.join_async()
        async_s = time.perf_counter() - t
        for leaf, k in zip(tree_leaves(st.params), kept):
            leaf.copy_(k)
        del kept
        a, ua, ma = checkpoint.load_sharded(sync, like_params=st.params,
                                            like_updater=st.updater)
        b, ub, mb = checkpoint.load_sharded(lazy, like_params=st.params,
                                            like_updater=st.updater)
    pairs = list(zip(tree_leaves((a, ua)), tree_leaves((b, ub))))
    return {"leaves": len(pairs),
            "bytes": sum(t.numel() * t.element_size() for t, _ in pairs),
            "bitwise": ma == mb and all(torch.equal(p, q) for p, q in pairs),
            "save_sharded_s": sync_s, "save_sharded_async_call_s": call_s,
            "save_sharded_async_join_s": async_s}


def dp_ckpt_child(workdir) -> int:
    """The data-parallel checkpoint child (`chip_smoke.py --dp-ckpt-child
    DIR`): the flagship at DP_CKPT's depth through a checkpointed trainer
    `fit` over DP_CKPT["batches"] batches, stopped by a real SIGTERM after
    DP_CKPT["stop"], rerun from its checkpoint, against an uninterrupted
    run. Prints one JSON line; exits 1 on a failed check."""
    import signal

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        DataParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.reliability import TrainingInterrupted

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DP_CKPT
    conf = train_conf("bfloat16", n_blocks=cfg["blocks"])
    mesh = make_mesh({"dp": 1}, device="cuda")
    rng = np.random.RandomState(1)
    seq = SLICE["seq"]
    batches = []
    for _ in range(cfg["batches"]):
        ids = rng.randint(0, SLICE["vocab"], (cfg["rows"], seq + 1))
        batches.append((ids[:, :-1].astype(np.int32),
                        ids[:, 1:].reshape(-1).astype(np.int32)))

    class Kill:
        def __init__(self):
            self.n = 0

        def iteration_done(self, model, iteration, score):
            self.n += 1
            if self.n == cfg["stop"]:
                os.kill(os.getpid(), signal.SIGTERM)

    def fresh(listeners=()):
        return DataParallelTrainer(dp_net(conf), mesh,
                                   listeners=list(listeners))

    ref = fresh()
    ref.fit(batches)
    want = dp_snapshot(ref)
    del ref
    ck = os.path.join(workdir, "ck")
    first = fresh([Kill()])
    try:
        first.fit(batches, checkpoint_dir=ck)
        interrupted = False
    except TrainingInterrupted:
        interrupted = True
    write_s = first.checkpoint_write_seconds
    del first
    resumed = fresh()
    resumed.fit(batches, checkpoint_dir=ck)
    gap = dp_gap(torch, dp_snapshot(resumed), want)
    out = {"blocks": cfg["blocks"], "rows": cfg["rows"],
           "batches": cfg["batches"], "sigterm_after": cfg["stop"],
           "interrupted": interrupted,
           "resumed_from_step": resumed.resumed_from_step,
           "checkpoint_write_s": {"at_sigterm": write_s,
                                  "final": resumed.checkpoint_write_seconds},
           "checkpoint_bytes": sum(
               os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck)),
           "resumed_vs_uninterrupted": gap}
    ok = (interrupted and resumed.resumed_from_step == cfg["stop"]
          and gap["bitwise"])
    out["ok"] = bool(ok)
    print(json.dumps(out), flush=True)
    dp_close()
    return 0 if ok else 1


def dp_checkpoint(torch):
    """`dp_ckpt_child` in a child process; the parent checks its line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--dp-ckpt-child",
             td], capture_output=True, text=True, timeout=400)
    lines = proc.stdout.strip().splitlines()
    try:
        row = json.loads(lines[-1])
    except (IndexError, ValueError):
        row = {"stdout_tail": proc.stdout[-2000:]}
    row = {"phase": "data_parallel_checkpoint",
           "seconds": time.perf_counter() - t0, "rc": proc.returncode, **row}
    emit(row)
    check(proc.returncode == 0 and row.get("ok"),
          f"data_parallel checkpoint failed (rc {proc.returncode}): "
          f"{proc.stderr[-3000:]}")


def phase_data_parallel(torch, kernels):
    """Slice 19's data-parallel training (module docstring, item 17).
    Returns the launches of the flash kernels and the LSTM cell in the
    trainers' captured steps."""
    t0 = time.perf_counter()
    card = gpu_line()
    launches = dp_flagship(torch, kernels, card)
    dp_free(torch)
    dp_checkpoint(torch)
    launches["lstm_cell"] = dp_lstm(torch, kernels, card)
    dp_free(torch)
    dp_vgg(torch, kernels, card)
    dp_free(torch)
    emit({"phase": "data_parallel", "gpu": card,
          "seconds": time.perf_counter() - t0, "launches": launches})
    dp_close()
    return launches


def dp_close() -> None:
    """End this process's process group (the trainers' NCCL
    communicator)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


# -- tensor parallelism -------------------------------------------------------

#: the flagship through `DataParallelTrainer(plan=)`: RandomState(0)'s 32 x
#: 512 ids (the data_parallel phase's batch), `steps` steps held to the
#: sync trainer (one card) or the one-rank plan run (four), `timed` replays
TP = dict(rows=32, steps=2, timed=3)
#: the sharded checkpoint on four cards: the flagship at `blocks` blocks,
#: batches of `rows`, checkpointed after `batches` batches by 2 x 2 and
#: resumed on 1 x 4
TP_CKPT = dict(blocks=2, rows=8, batches=2)
#: the model axes whose per-rank heads (H / M) rows 1-4 are checked and
#: timed at
TP_MODELS = (2, 4)
#: the layouts of the four-card run: (batch, model, zero1)
TP_LAYOUTS = ((1, 4, False), (2, 2, False), (2, 2, True))
#: ring and Ulysses attention: the flagship's heads and head dim, `seq`
#: positions a rank, f32; the pipeline: `micro` microbatches of `rows` at
#: d_model through one tanh layer a stage; MoE: `tokens` tokens at d_model,
#: `experts` experts of `hidden`, capacity ample (factor = experts)
TP_SEQ = dict(batch=2, seq=512)
TP_PIPE = dict(micro=4, rows=8)
TP_MOE = dict(tokens=1024, hidden=4096, experts=8)
#: the four-card runs against the one-rank plan run, at equal steps. The
#: scores step by step, relative (bf16 products summed over other partial
#: sums: at most 5.6e-5 measured on H100).
TP_SCORE_RTOL = 2e-4
#: Adam steps an element by about +-lr whatever its gradient's size, so
#: where rounding flips a near-zero gradient's sign the two runs part by
#: 2 lr: the gate is the share of elements more than half a step apart
#: (the key bias left out: its gradient is zero in exact arithmetic), and
#: the moments' relative L2 gap, which the large gradients dominate
TP_PARAM_ATOL = 0.5 * TRAIN_LR
TP_PARAM_SHARE = 5e-3
TP_MOMENT_RTOL = 3e-2
#: how far two Adam runs of n steps can part in any element: 2 n lr
#: (Adam's bias-corrected step exceeds lr by under 1 % in 3 steps)
TP_ADAM_REACH = 2 * 1.01
TP_DEVICE = "cuda"


def tp_net(conf):
    """A network of `conf` at seed 0 on this rank's device."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.mesh import rank_device

    return MultiLayerNetwork(conf, device=rank_device(TP_DEVICE),
                             seed=0).init()


def tp_plan(batch, model, group=None):
    from deeplearning4j_tpu_torch.parallel.plan import ShardPlan, plan_mesh

    return ShardPlan(mesh=plan_mesh({"batch": batch, "model": model},
                                    device=TP_DEVICE, group=group))


def tp_batch(rows, seed=0, n=1):
    """`n` batches of `rows` x SLICE["seq"] ids and their next-id labels."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, SLICE["vocab"], (rows, SLICE["seq"] + 1))
        out.append((ids[:, :-1].astype(np.int32),
                    ids[:, 1:].reshape(-1).astype(np.int32)))
    return out


def tp_state_bytes(trainer) -> dict:
    """This rank's bytes of params and of updater moments."""
    flat = trainer.state.flat

    def size(bufs):
        return sum(b.numel() * b.element_size() for b in bufs)

    return {"params_bytes": size(flat.params),
            "moments_bytes": size(flat.hist) + size(flat.vel)}


def tp_gathered(trainer, moments=False):
    """The trainer's params (and with `moments` its updater's hist and
    vel) gathered whole, as named host copies (a collective over every
    rank)."""
    params, updater, _ = trainer.gathered_state()
    trees = [("params", params)]
    if moments:
        trees += [("hist", updater.adagrad_hist), ("vel", updater.velocity)]
    return [(f"{field}/{i}.{k}", t.detach().to("cpu", copy=True))
            for field, tree in trees for i, layer in enumerate(tree)
            for k, t in sorted(layer.items())]


def tp_state_gap(torch, got, want) -> dict:
    """`tp_gathered(..., moments=True)` of two runs after as many steps:
    of the params, the largest gap in the attention key bias (the middle
    third of each `bqkv`) and in every other element, the leaf that holds
    the latter, and the share of those elements more than TP_PARAM_ATOL
    apart; of each moment, |got - want| / |want| in L2 over all leaves."""
    key, top, leaf, over, n = 0.0, 0.0, None, 0, 0
    sq = {"hist": [0.0, 0.0], "vel": [0.0, 0.0]}
    for (name, a), (_, b) in zip(got, want):
        diff = a.double() - b.double()
        field = name.split("/")[0]
        if field != "params":
            sq[field][0] += float(torch.sum(diff * diff))
            sq[field][1] += float(torch.sum(b.double() ** 2))
            continue
        diff = diff.abs().reshape(-1)
        if name.endswith(".bqkv"):
            d = diff.numel() // 3
            key = max(key, float(diff[d:2 * d].max()))
            diff = torch.cat([diff[:d], diff[2 * d:]])
        if float(diff.max()) > top or leaf is None:
            top, leaf = float(diff.max()), name
        over += int((diff > TP_PARAM_ATOL).sum())
        n += diff.numel()
    return {"key_bias_max_abs_diff": key, "max_abs_diff": top,
            "max_leaf": leaf, "over_atol_share": over / n,
            **{f"{f}_rel_l2": (d / w) ** 0.5 for f, (d, w) in sq.items()}}


def tp_state_fails(gap, reach) -> list:
    """What of `tp_state_gap`'s row breaks the gates."""
    fails = []
    if max(gap["key_bias_max_abs_diff"], gap["max_abs_diff"]) > reach:
        fails.append(f"a param moved beyond Adam's reach {reach}")
    if gap["over_atol_share"] > TP_PARAM_SHARE:
        fails.append(f"share over {TP_PARAM_ATOL} > {TP_PARAM_SHARE}")
    for f in ("hist", "vel"):
        if gap[f"{f}_rel_l2"] > TP_MOMENT_RTOL:
            fails.append(f"{f} relative L2 gap > {TP_MOMENT_RTOL}")
    return fails


def tp_collectives_want(n_blocks, zero1):
    """The collectives one captured plan step issues: per block two
    all-reduces forward (after Wo, after W2) and two backward (the
    gradient of each copy-to-model), the gradient's over the batch group
    (ZeRO-1: a reduce-scatter, and the params' all-gather) and the
    score's."""
    return {"all_reduce": 4 * n_blocks + (1 if zero1 else 2),
            "reduce_scatter": int(zero1), "all_gather": int(zero1)}


def tp_kernel_rows(torch, kernels):
    """Rows 1-4 at the per-rank shapes of the plan step, [32, 512, H/M,
    128] for M in TP_MODELS (bf16, causal, q/k/v views of one rank's
    head-aligned projection), against their plain versions, timed beside
    the bound and SDPA. Returns {M: {kernel: row}}."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for m in TP_MODELS:
        h = SLICE["n_heads"] // m
        case = (TP["rows"], SLICE["seq"], h, SLICE["d_model"] // SLICE[
            "n_heads"], torch.bfloat16, True, True, True)
        rows = {"flash_attn_fwd": fwd_kernel_row(
            torch, kernels, gen, case, phase="tensor_parallel_kernel")}
        rows.update(bwd_case_rows(torch, kernels, gen,
                                  case[:5] + (True, True),
                                  phase="tensor_parallel_kernel"))
        out[m] = rows
        torch.cuda.empty_cache()
    return out


def tp_modules(torch, world: int) -> dict:
    """Ring and Ulysses attention (the flagship's 16 heads of 128, S =
    TP_SEQ["seq"] a rank, causal and not, f32), the pipeline (a tanh layer
    of d_model a stage) and MoE (d_model, TP_MOE) over `world` ranks,
    each against its dense reference on the whole input (computed on every
    rank), at the JAX package's tolerances; ring and full attention timed
    by events."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nd.attention import full_attention
    from deeplearning4j_tpu_torch.parallel import expert, pipeline, sequence
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    dev = make_mesh({"sp": world}, device=TP_DEVICE).device
    gen = torch.Generator(device=dev).manual_seed(5)

    def gather(t, dim):
        if world == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=dim)

    def close(got, want, rtol, atol):
        err = (got - want).abs().max().item()
        return err, bool(torch.allclose(got, want, rtol=rtol, atol=atol))

    rows = {}
    h, d = SLICE["n_heads"], SLICE["d_model"] // SLICE["n_heads"]
    b, s = TP_SEQ["batch"], TP_SEQ["seq"]
    mesh = make_mesh({"sp": world}, device=TP_DEVICE)
    r = mesh.coord("sp")
    q, k, v = (torch.randn(b, s * world, h, d, generator=gen, device=dev)
               for _ in range(3))
    do = torch.randn(b, s * world, h, d, generator=gen, device=dev)
    for kind in ("ring", "ulysses"):
        for causal in (False, True):
            shard = [t[:, r * s:(r + 1) * s].clone().requires_grad_()
                     for t in (q, k, v)]
            fn = sequence.make_context_parallel_attention(
                mesh, kind=kind, causal=causal)
            t0 = time.perf_counter()
            o = fn(*shard)
            o.backward(do[:, r * s:(r + 1) * s])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
            whole = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ref = full_attention(*whole, causal=causal)
            ref.backward(do)
            errs = {"o": close(gather(o.detach(), 1), ref.detach(), 2e-5,
                               2e-5)}
            for name, part, w in zip("qkv", shard, whole):
                errs[f"d{name}"] = close(gather(part.grad, 1), w.grad, 1e-3,
                                         1e-3)
            ms = (event_ms(torch, lambda: fn(*shard)) if dev.type == "cuda"
                  else None)
            full_ms = (event_ms(torch, lambda: full_attention(
                q, k, v, causal=causal)) if dev.type == "cuda" else None)
            rows[f"{kind}_{'causal' if causal else 'full'}"] = {
                "shape": [b, s * world, h, d], "ranks": world,
                "max_abs_err": {n: e for n, (e, _) in errs.items()},
                "ok": all(ok for _, ok in errs.values()),
                "forward_ms": ms, "full_attention_ms": full_ms,
                "forward_backward_wall_ms": wall}
    del q, k, v, do
    # the pipeline: every rank draws every stage, keeps its own
    pmesh = make_mesh({"pp": world}, device=TP_DEVICE)
    width = SLICE["d_model"]
    ws = torch.randn(world, width, width, generator=gen, device=dev) * (
        1.0 / width ** 0.5)
    bs = torch.randn(world, width, generator=gen, device=dev) * 0.1
    x = torch.randn(TP_PIPE["micro"], TP_PIPE["rows"], width,
                    generator=gen, device=dev)
    st = pmesh.coord("pp")

    def stage(p, a):
        return torch.tanh(a @ p["W"] + p["b"])

    mine = {"W": ws[st].clone().requires_grad_(),
            "b": bs[st].clone().requires_grad_()}
    out = pipeline.pipeline_apply(stage, mine, x, pmesh, axis="pp")
    (out ** 2).mean().backward()
    allp = {"W": ws.clone().requires_grad_(), "b": bs.clone().requires_grad_()}
    seq_out = x
    for i in range(world):
        seq_out = stage({"W": allp["W"][i], "b": allp["b"][i]}, seq_out)
    (seq_out ** 2).mean().backward()
    errs = {"out": close(out.detach(), seq_out.detach(), 1e-5, 1e-5),
            "dW": close(mine["W"].grad, allp["W"].grad[st], 1e-4, 1e-5),
            "db": close(mine["b"].grad, allp["b"].grad[st], 1e-4, 1e-5)}
    rows["pipeline"] = {"stages": world, "micro": TP_PIPE["micro"],
                        "rows": TP_PIPE["rows"], "width": width,
                        "max_abs_err": {n: e for n, (e, _) in errs.items()},
                        "ok": all(ok for _, ok in errs.values())}
    del ws, bs, x, allp, mine, out, seq_out
    # MoE: every rank draws every expert, keeps its share
    emesh = make_mesh({"ep": world}, device=TP_DEVICE)
    er = emesh.coord("ep")
    e, t = TP_MOE["experts"], TP_MOE["tokens"]
    full = expert.init_moe_params(gen, width, TP_MOE["hidden"], e)
    x = torch.randn(t, width, generator=gen, device=dev)
    e_loc, t_loc = e // world, t // world
    mp = {"router": full["router"].clone().requires_grad_()}
    for name in ("W1", "b1", "W2", "b2"):
        mp[name] = full[name][er * e_loc:(er + 1) * e_loc].clone() \
            .requires_grad_()
    y, aux = expert.moe_ffn(mp, x[er * t_loc:(er + 1) * t_loc], emesh,
                            capacity_factor=float(e))
    ((y ** 2).sum() / x.numel() + 0.01 * aux).backward()
    dense = {k: a.clone().requires_grad_() for k, a in full.items()}
    yd, auxd = expert.moe_ffn_dense(dense, x, capacity_factor=float(e))
    ((yd ** 2).mean() + 0.01 * auxd).backward()
    errs = {"y": close(gather(y.detach(), 0), yd.detach(), 2e-4, 2e-4),
            "aux": close(aux.detach().reshape(1), auxd.detach().reshape(1),
                         1e-5, 0.0),
            "router": close(mp["router"].grad, dense["router"].grad, 1e-4,
                            1e-6)}
    for name in ("W1", "b1", "W2", "b2"):
        errs[name] = close(mp[name].grad, dense[name].grad[
            er * e_loc:(er + 1) * e_loc], 1e-4, 1e-6)
    rows["moe"] = {"shards": world, "tokens": t, "d_model": width,
                   "hidden": TP_MOE["hidden"], "experts": e,
                   "max_abs_err": {n: err for n, (err, _) in errs.items()},
                   "ok": all(ok for _, ok in errs.values())}
    return rows


def tp_one_card(torch, kernels, card):
    """The flagship through `DataParallelTrainer(plan=ShardPlan(plan_mesh(
    {"batch": 1, "model": 1})))` against the sync trainer, step by step
    (bitwise), rows 1-4's launches a step (host counts and a profiled
    replay), the step's times. Returns the launches of rows 1-4."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        CAPTURED_COLLECTIVES, DataParallelTrainer)
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    conf = train_conf("bfloat16")
    (x, y), = tp_batch(TP["rows"])
    sync = DataParallelTrainer(tp_net(conf), make_mesh({"dp": 1},
                                                       device=TP_DEVICE))
    snaps, sync_scores = [], []
    for _ in range(TP["steps"]):
        sync_scores.append(sync.fit([(x, y)]))
        snaps.append(dp_snapshot(sync))
    del sync
    dp_free(torch)
    torch.cuda.reset_peak_memory_stats()
    before = dict(CAPTURED_COLLECTIVES)
    plan = tp_plan(1, 1)
    t = DataParallelTrainer(tp_net(conf), plan=plan)
    gaps, launches, fit_ms, scores = [], [], [], []
    for snap in snaps:
        kernels.reset_launches()
        fit_ms.append(event_ms(torch, lambda: scores.append(
            t.fit([(x, y)]))))
        launches.append(dict(kernels.LAUNCHES))
        gaps.append(dp_gap(torch, dp_snapshot(t), snap))
    captured = {k: v - before[k] for k, v in CAPTURED_COLLECTIVES.items()}
    step_ms, step = dp_step_times(torch, t, x, y, TP["timed"])
    books = dp_books(t)
    profile = dp_profile(torch, kernels, step, "tensor_parallel_profile")
    median_ms = median(step_ms)
    n_attn = SLICE["n_blocks"]
    row = {"phase": "tensor_parallel_one_card", "gpu": card,
           "config": SLICE, "rows": TP["rows"], "plan": plan.describe(),
           "sharding_tag": list(plan.sharding_tag()),
           "key": repr(t._step.variant), "lr": TRAIN_LR,
           "plan_vs_sync": gaps, "scores": scores,
           "sync_scores": sync_scores, "fit_ms": fit_ms,
           "step_ms": step_ms, "step_ms_median": median_ms,
           "tokens_per_s": TP["rows"] * SLICE["seq"] / (median_ms / 1e3),
           "launches_per_step": launches, "collectives_in_graph": captured,
           "graph": books, **tp_state_bytes(t),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "device_ms": profile["device_ms"],
           "idle_share": 1.0 - profile["device_ms"] / profile["wall_ms"],
           "by_kind_ms": profile["by_kind_ms"],
           "flash_calls_in_replay": profile["flash_calls"],
           "seconds": time.perf_counter() - t0}
    emit(row)
    del t
    dp_free(torch)
    for i, gap in enumerate(gaps):
        check(gap["bitwise"], f"tensor_parallel: the 1 x 1 plan step "
              f"{i + 1} differs from the sync trainer's: {gap}")
    for launch in launches:
        for name in DP_FLASH:
            check(launch[name] == n_attn,
                  f"tensor_parallel: a step launched {name} "
                  f"{launch[name]} times, want {n_attn}: {launch}")
    for name, calls in profile["flash_calls"].items():
        check(calls == n_attn, f"tensor_parallel: the profiled replay ran "
              f"{name} {calls} times, want {n_attn}")
    check(books["dp_step_cache"]["misses"] == 1,
          f"tensor_parallel: captured under traffic: {books}")
    return {name: sum(launch[name] for launch in launches)
            for name in DP_FLASH}


def phase_tensor_parallel(torch, kernels):
    """Tensor parallelism on one card (module docstring, item 18).
    Returns the launches of rows 1-4 in the plan trainer's captured steps,
    and the kernel rows at the per-rank shapes."""
    t0 = time.perf_counter()
    card = gpu_line()
    launches = tp_one_card(torch, kernels, card)
    kernel_rows = tp_kernel_rows(torch, kernels)
    modules = tp_modules(torch, 1)
    emit({"phase": "tensor_parallel_modules", "gpu": card, **modules})
    for name, r in modules.items():
        check(r["ok"], f"tensor_parallel: {name} disagrees with its dense "
              f"reference: {r}")
    summary = {"phase": "tensor_parallel", "gpu": card,
               "seconds": time.perf_counter() - t0, "launches": launches,
               "kernels": {str(m): {name: {k: r[k] for k in (
                   "shape", "max_abs_err", "kernel_ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms", "sdpa_backward_ms",
                   "vecdot_ms") if k in r}
                   for name, r in rows.items()}
                   for m, rows in kernel_rows.items()}}
    emit(summary)
    dp_close()
    return summary


def tp_ranks(torch, kernels) -> int:
    """Tensor parallelism on the cards of a torchrun group (`torchrun
    --nproc-per-node 4 chip_smoke.py --only-tensor-parallel`; module
    docstring, item 18): the one-rank plan run on rank 0 alone, then each
    layout of TP_LAYOUTS at full width, held to it; the sharded checkpoint
    of 2 x 2 resumed on 1 x 4; ring, Ulysses, the pipeline and MoE over
    every rank. Rank 0 prints the lines; every rank checks."""
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        CAPTURED_COLLECTIVES, DataParallelTrainer)
    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed

    t_all = time.perf_counter()
    _, dev = init_distributed(TP_DEVICE)
    rank, world = dist.get_rank(), dist.get_world_size()
    lead = rank == 0
    card = gpu_line() if lead else None

    def say(obj):
        if lead:
            emit(obj)

    conf = train_conf("bfloat16")
    n_blocks = SLICE["n_blocks"]
    (x, y), = tp_batch(TP["rows"])
    # the one-rank reference: rank 0 alone, the others wait
    solo = dist.new_group([0])
    ref = None
    reach = TP_ADAM_REACH * TP["steps"] * TRAIN_LR
    fails = []
    if lead:
        t = DataParallelTrainer(tp_net(conf), plan=tp_plan(1, 1, solo))
        init = tp_gathered(t)
        scores = [t.fit([(x, y)]) for _ in range(TP["steps"])]
        state = tp_gathered(t, moments=True)
        ref = {"state": state, "scores": scores,
               "moved": dp_gap(torch, state[:len(init)],
                               init)["max_abs_diff"]}
        del t, init
        dp_free(torch)
        # the control: the steps on half the batch, as a 2 x 2 step that
        # dropped the batch group's gradient all-reduce takes them on
        # each batch rank; the gates must tell it from the reference
        half = TP["rows"] // 2
        t = DataParallelTrainer(tp_net(conf), plan=tp_plan(1, 1, solo))
        for _ in range(TP["steps"]):
            t.fit([(x[:half], y[:half * SLICE["seq"]])])
        control = tp_state_gap(torch, tp_gathered(t, moments=True),
                               state)
        del t
        dp_free(torch)
        say({"phase": "tensor_parallel_control", "gpu": card,
             "rows": half, "steps": TP["steps"], "vs_one_rank": control,
             "gates_broken": tp_state_fails(control, reach)})
        if len(tp_state_fails(control, reach)) < 3:
            fails.append(f"the gates do not tell a half-batch update from "
                         f"the reference: {control}")
    dist.barrier()
    layouts = []
    for b, m, zero1 in TP_LAYOUTS:
        t0 = time.perf_counter()
        plan = tp_plan(b, m)
        before = dict(CAPTURED_COLLECTIVES)
        torch.cuda.reset_peak_memory_stats()
        t = DataParallelTrainer(tp_net(conf), plan=plan, zero1=zero1)
        scores, fit_ms = [], []
        for _ in range(TP["steps"]):
            fit_ms.append(event_ms(torch, lambda: scores.append(
                t.fit([(x, y)]))))
        captured = {k: v - before[k] for k, v in CAPTURED_COLLECTIVES.items()}
        # the state after the reference's steps, before the timed ones
        gathered = tp_gathered(t, moments=True)
        step_ms, step = dp_step_times(torch, t, x, y, TP["timed"])
        profile = dp_profile(torch, kernels, step,
                             "tensor_parallel_profile", quiet=True)
        nccl_ms = sum(r["ms"] for r in profile["nccl"])
        mine = {"rank": rank, "coords": {a: plan.mesh.coord(a)
                                         for a in plan.mesh.axis_names},
                **tp_state_bytes(t), "step_ms": step_ms,
                "step_ms_median": median(step_ms),
                "tokens_per_s": TP["rows"] * SLICE["seq"] / (
                    median(step_ms) / 1e3),
                "fit_ms": fit_ms, "device_ms": profile["device_ms"],
                "nccl_ms": nccl_ms,
                "nccl_share": nccl_ms / max(profile["device_ms"], 1e-9),
                "nccl": profile["nccl"],
                "flash_calls_in_replay": profile["flash_calls"],
                "collectives_in_graph": captured,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        row = {"phase": "tensor_parallel_layout", "gpu": card,
               "layout": {"batch": b, "model": m}, "zero1": zero1,
               "sharding_tag": list(plan.sharding_tag()),
               "scores": scores, "ranks": ranks,
               "seconds": time.perf_counter() - t0}
        want = tp_collectives_want(n_blocks, zero1)
        if lead:
            gap = tp_state_gap(torch, gathered, ref["state"])
            rel = [abs(a - r) / abs(r) for a, r in zip(scores,
                                                       ref["scores"])]
            row.update({"vs_one_rank": {
                **gap, "steps": TP["steps"], "scores": ref["scores"],
                "score_rel_diff": rel, "one_rank_moved": ref["moved"]}})
            fails += [f"tensor_parallel {b}x{m}: {f}: {gap}"
                      for f in tp_state_fails(gap, reach)]
            if max(rel) > TP_SCORE_RTOL:
                fails.append(f"tensor_parallel {b}x{m}: scores {scores} "
                             f"against the one-rank run's {ref['scores']}")
        say(row)
        layouts.append(row)
        check(captured == want, f"tensor_parallel {b}x{m}: collectives in "
              f"the captured step {captured}, want {want}")
        for name, calls in profile["flash_calls"].items():
            check(calls == n_blocks, f"tensor_parallel {b}x{m}: the "
                  f"profiled replay ran {name} {calls} times")
        del t, gathered
        dp_free(torch)
    check(not fails, "; ".join(fails))
    # the sharded checkpoint: 2 x 2 (ZeRO-1) writes, 1 x 4 resumes
    t0 = time.perf_counter()
    cconf = train_conf("bfloat16", n_blocks=TP_CKPT["blocks"])
    batches = tp_batch(TP_CKPT["rows"], seed=1, n=TP_CKPT["batches"] + 1)
    box = [tempfile.mkdtemp(prefix="tp-ck-") if lead else None]
    dist.broadcast_object_list(box, src=0)
    ck = os.path.join(box[0], "ck")
    w = DataParallelTrainer(tp_net(cconf), plan=tp_plan(2, 2), zero1=True)
    w.fit(batches[:TP_CKPT["batches"]], checkpoint_dir=ck)
    written = tp_gathered(w)
    write_s = w.checkpoint_write_seconds
    del w
    r = DataParallelTrainer(tp_net(cconf), plan=tp_plan(1, 4))
    step = r.restore(ck)
    restored = tp_gathered(r)
    more = r.fit(batches[TP_CKPT["batches"]:])
    gap = dp_gap(torch, restored, written)
    ckpt = {"phase": "tensor_parallel_checkpoint", "gpu": card,
            "blocks": TP_CKPT["blocks"], "written_by": {"batch": 2,
                                                        "model": 2},
            "zero1": True, "resumed_on": {"batch": 1, "model": 4},
            "restored_step": step, "restored_vs_written": gap,
            "score_after": more, "write_s": write_s,
            "bytes": (sum(os.path.getsize(os.path.join(ck, f))
                          for f in os.listdir(ck)) if lead else None),
            "seconds": time.perf_counter() - t0}
    say(ckpt)
    check(step == TP_CKPT["batches"] and gap["bitwise"]
          and np.isfinite(more), f"tensor_parallel checkpoint: {ckpt}")
    del r
    dp_free(torch)
    dist.barrier()
    if lead:
        import shutil

        shutil.rmtree(box[0], ignore_errors=True)
    modules = tp_modules(torch, world)
    say({"phase": "tensor_parallel_modules", "gpu": card, **modules})
    for name, row in modules.items():
        check(row["ok"], f"tensor_parallel: {name} over {world} ranks "
              f"disagrees with its dense reference: {row}")
    say({"phase": "tensor_parallel_ranks", "gpu": card, "ranks": world,
         "seconds": time.perf_counter() - t_all})
    if lead:
        print(card, flush=True)
    dp_close()
    return 0


# -- serving under a mesh -----------------------------------------------------

#: the serve_mesh phase: the flagship (SLICE, bf16 compute) at seed 0 served
#: with no mesh, under the 1-D mesh and under the (batch, model) plan:
#: `rows` x SLICE["seq"] ids through `output`, then `requests` prompts of
#: `prompt` ids (RandomState(5)), `new` tokens each, half greedy and half at
#: 0.8, through a `slots`-slot `ContinuousBatcher` of the generate phase's
#: tables and buckets, a pass per option: dense, paged (`page_size`-token
#: pages), K = `k` blocks, the prefix cache (the prompts twice: exact hits)
#: and speculative (GEN_SPEC's char-LSTM draft, spec_k `spec_k`)
SM = dict(rows=4, requests=4, prompt=(40, 250), new=32, slots=4,
          max_seq=512, buckets=(64, 256), page_size=16, k=8, spec_k=4)
#: the per-rank prefill shapes row 1 is held at, [1, S, H/M, 128]: (S, M)
SM_PREFILL = ((64, 2), (256, 2), (64, 4), (256, 4))
#: four cards: the layouts (batch, model), and the CPU test's f32 net
#: (tests/test_torch_serve_mesh.py), `new` greedy tokens of `prompt`
SM_LAYOUTS = ((1, 4), (2, 2), (4, 1))
SM_SMALL = dict(vocab=32, d_model=16, n_blocks=2, n_heads=4, seq=32,
                prompt=[1, 7, 3], new=8, bucket=8, page_size=8)
SM_DEVICE = "cuda"
#: four cards: how far a layout's bf16 output may be from the f32 net of
#: the same params, in multiples of one card's bf16 gap to it (two
#: independent bf16 errors of one size add to about sqrt(2) of one); each
#: control of SM_CONTROLS must land above it
SM_BF16_REACH = 2.0
#: four cards: the deliberate faults of the model axis that the output gate
#: must catch, at SM_CONTROL_LAYOUT: "unreduced" (`Wo`'s and `W2`'s partial
#: products not all-reduced), "wrong_wo" (each rank's `Wo` rows those of
#: the next rank's heads)
SM_CONTROLS = ("unreduced", "wrong_wo")
SM_CONTROL_LAYOUT = (1, 4)


@contextlib.contextmanager
def sm_control(name):
    """Serving with the model-axis fault `name` of SM_CONTROLS, on every
    rank that enters it."""
    from deeplearning4j_tpu_torch.parallel import tensor

    if name == "unreduced":
        attr, owner = "reduce_from_model", tensor.ServeParallel

        def fault(self, x):
            return x
    else:
        attr, owner = "shard_params", tensor

        def fault(params, tp):
            return tuple({k: tensor.shard_leaf(
                t, tp.layout.get((i, k)), tp.size,
                (tp.rank + 1) % tp.size if k == "Wo" else tp.rank)
                for k, t in layer.items()} for i, layer in enumerate(params))
    good = getattr(owner, attr)
    setattr(owner, attr, fault)
    try:
        yield
    finally:
        setattr(owner, attr, good)


def sm_net(torch, conf, seed=0):
    """(network of `conf` at `seed` on this rank's device, its `init`
    seconds: the params drawn leaf by leaf from JAX's threefry key)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.mesh import rank_device

    dev = rank_device(SM_DEVICE)
    net = MultiLayerNetwork(conf, device=dev, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.init()
    torch.cuda.synchronize()
    return net, time.perf_counter() - t0


def sm_init_vs_cpu(torch, net, layers=(0, 1, 2)) -> dict:
    """The card's initial params against the same layers drawn on this
    machine's CPU from the same key (`init_params`' split): the uniform
    leaves bit for bit, the normal one (the positional table) within
    4 float32 ulps (erfinv's last place). Returns the row."""
    from deeplearning4j_tpu_torch.nd import random as nd_random
    from deeplearning4j_tpu_torch.nn.layers import get_layer

    conf = net.conf
    key = nd_random.split_host((0, net.seed & 0xFFFFFFFF))[1]
    keys = nd_random.split(torch.tensor(key, dtype=torch.int64),
                           max(1, conf.n_layers))
    leaves = {}
    for i in layers:
        c = conf.conf(i)
        cpu = get_layer(c.layer_type).init(keys[i], c)
        for name, want in cpu.items():
            got = net.params[i][name].detach().cpu()
            diff = (got.double() - want.double()).abs()
            scale = want.double().abs().clamp_min(1.0)
            leaves[f"{i}.{name}"] = {
                "bitwise": bool(torch.equal(got, want)),
                "max_ulps": float((diff / (scale * 2.0 ** -23)).max())}
    ok = all(r["bitwise"] or (name.endswith(".P") and r["max_ulps"] <= 4)
             for name, r in leaves.items())
    return {"leaves": leaves, "ok": ok}


def sm_requests(n=None):
    rng = np.random.RandomState(5)
    n = SM["requests"] if n is None else n
    lo, hi = SM["prompt"]
    prompts = [rng.randint(0, SLICE["vocab"], rng.randint(lo, hi + 1))
               .tolist() for _ in range(n)]
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(n)]
    return prompts, temps


def sm_pass(torch, kernels, net, prompts, temps, **options):
    """`warmup_generate` for `options`, then the prompts through a batcher
    of them (`batcher_streams`); the kernel counts set to 0 just before
    the batcher runs and read just after. Returns (tokens, the row)."""
    warm = {k: v for k, v in options.items() if k != "prefix_match"}
    net.warmup_generate(slots=SM["slots"], max_seq=SM["max_seq"],
                        prompt_buckets=SM["buckets"], **warm)
    torch.cuda.synchronize()
    misses = net.infer_cache.stats.misses
    kernels.reset_launches()
    toks, stats, wall = batcher_streams(
        torch, net, prompts, temps, SM["new"], SM["slots"], SM["max_seq"],
        SM["buckets"], **options)
    n_tok = sum(len(t) for t in toks)
    return toks, {"tokens": n_tok, "wall_s": wall,
                  "tokens_per_s": n_tok / wall,
                  "ttft_ms_p50": stats["ttft_ms"]["p50"],
                  "launches": dict(kernels.LAUNCHES),
                  "captured_while_serving":
                      net.infer_cache.stats.misses - misses}


def sm_bytes(torch, net) -> dict:
    """This rank's bytes of params the programs read and of the decode
    table (dense, SM's slots and max_seq)."""
    ic = net.infer_cache
    params = ic._local_params(net.conf, net.params)
    table = ic.decode_state(net.conf, SM["slots"], SM["max_seq"],
                            net.device, "table")
    return {"params": sum(t.numel() * t.element_size()
                          for lay in params for t in lay.values()),
            "kv_table": sum(t.numel() * t.element_size()
                            for lay in table for n, t in lay.items()
                            if n in ("k", "v"))}


def sm_output_ms(torch, net, x) -> float:
    """Median of 5 host-clock `net.output` calls (replays) after one."""
    net.output(x)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return median(times)


#: the option passes of the one-card run: name -> batcher options
SM_OPTIONS = {"dense": {}, "paged": {"page_size": SM["page_size"]},
              "block": {"steps_per_dispatch": SM["k"]},
              "prefix": {"prefix_cache": True}}


def sm_one_card(torch, kernels, card) -> dict:
    """Serving under a mesh on one card (the plain run's check): `output`
    under the 1-D mesh and under batch=1,model=1 bitwise the single-card
    cache's; every option pass under batch=1,model=1 token-identical to
    the single-card pass; the 1-D mesh's generation on the "single"
    programs (no capture); the keys' tags; latency, tokens/s and bytes.
    Returns the flash launches of the mesh runs and the phase's rows."""
    from deeplearning4j_tpu_torch.parallel.plan import ShardPlan

    t0 = time.perf_counter()
    conf = gen_conf(SLICE["n_blocks"])
    net, init_s = sm_net(torch, conf)
    n_params = sum(t.numel() for lay in net.params for t in lay.values())
    init_row = {"phase": "serve_mesh_init", "gpu": card,
                "n_params": n_params, "init_s": init_s,
                **sm_init_vs_cpu(torch, net)}
    emit(init_row)
    check(init_row["ok"], f"serve_mesh: the card's initial params are not "
          f"the CPU's: {init_row}")
    ic = net.infer_cache
    nb = SLICE["n_blocks"]
    x = torch.as_tensor(np.random.RandomState(3).randint(
        0, SLICE["vocab"], (SM["rows"], SLICE["seq"])).astype(np.int32),
        device=net.device)
    prompts, temps = sm_requests()
    draft = spec_draft(SLICE["vocab"], GEN_SPEC["draft_seed"])
    options = dict(SM_OPTIONS, spec={"draft_net": draft,
                                     "spec_k": SM["spec_k"]})
    launches = {"output": 0, "generate": 0}
    rows = {}
    for mesh in (None, "batch=1,model=1", "all"):
        if mesh is None:
            ic.set_mesh(None)
        else:
            net.set_serve_mesh(spec=mesh)
        plan = ShardPlan(mesh=ic.mesh)
        kernels.reset_launches()
        out = net.output(x)
        torch.cuda.synchronize()
        out_launches = kernels.LAUNCHES["flash_attn_fwd"]
        row = {"plan": plan.describe(), "output_ms": sm_output_ms(
            torch, net, x), "output_flash_launches": out_launches,
               "bytes": sm_bytes(torch, net), "passes": {}}
        if mesh is None:
            ref_out, streams = out, {}
        else:
            row["output_bitwise"] = bool(torch.equal(out, ref_out))
            launches["output"] += out_launches
            check(row["output_bitwise"], f"serve_mesh {mesh}: the output "
                  f"differs from the single-card cache's")
        check(out_launches == nb, f"serve_mesh {mesh}: output launched "
              f"flash {out_launches} times, want {nb}")
        misses = ic.stats.misses
        for name, opts in options.items():
            reps = 2 if name == "prefix" else 1
            toks, r = sm_pass(torch, kernels, net, prompts * reps,
                              temps * reps, **opts)
            row["passes"][name] = r
            admissions = len(prompts) * (1 if name == "prefix" else reps)
            flash = r["launches"]["flash_attn_fwd"]
            if mesh is None:
                streams[name] = toks
            else:
                launches["generate"] += flash
                r["tokens_identical"] = toks == streams[name]
                check(r["tokens_identical"], f"serve_mesh {mesh} {name}: "
                      f"the streams differ from the single-card pass's")
            check(flash == nb * admissions, f"serve_mesh {mesh} {name}: "
                  f"flash launches {flash}, want {nb * admissions}")
            check(r["captured_while_serving"] == 0,
                  f"serve_mesh {mesh} {name}: captured while serving")
        row["captures"] = ic.stats.misses - misses
        tags = {repr(k[3]) for k in ic._programs
                if k[0].startswith(("decode", "prefill", "verify"))}
        row["decode_tags"] = sorted(tags)
        if mesh == "all":
            # generation stays single under a 1-D mesh: the single-card
            # programs replay and nothing is captured for it
            check(row["captures"] == 0, f"serve_mesh all: generation "
                  f"captured {row['captures']} programs")
        rows[mesh or "single"] = row
        emit({"phase": "serve_mesh_pass", "gpu": card,
              "mesh": mesh or "single", **row})
    plan_tag = repr(("mesh", ("batch", "model"), (1, 1)))
    check(plan_tag in rows["batch=1,model=1"]["decode_tags"]
          and "'single'" in rows["single"]["decode_tags"],
          f"serve_mesh: decode tags "
          f"{[r['decode_tags'] for r in rows.values()]}")
    keys = [k for k in ic._programs if k[0] == "decode"]
    summary = {"phase": "serve_mesh_one_card", "gpu": card,
               "config": SLICE, "init_s": init_s,
               "decode_keys": sorted({repr(k[3]) for k in keys}),
               "hits": ic.stats.hits, "misses": ic.stats.misses,
               "seconds": time.perf_counter() - t0}
    emit(summary)
    ic.set_mesh(None)
    del net, draft
    dp_free(torch)
    return {"launches": launches, "rows": rows, "init_s": init_s,
            "n_params": n_params}


def sm_kernel_rows(torch, kernels) -> dict:
    """Row 1 at the per-rank prefill shapes [1, S, H/M, 128] (SM_PREFILL)
    and at the served shape [SM rows, 512, 16, 128] (bf16, causal, qkv
    views, no lse) against its plain version, beside the bound and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    d = SLICE["d_model"] // SLICE["n_heads"]
    cases = [("prefill", 1, s, SLICE["n_heads"] // m) for s, m in SM_PREFILL]
    cases.append(("served", SM["rows"], SLICE["seq"], SLICE["n_heads"]))
    out = {}
    for kind, b, s, h in cases:
        row = fwd_kernel_row(torch, kernels, gen, (
            b, s, h, d, torch.bfloat16, True, False, True),
            phase="serve_mesh_kernel")
        out[f"{kind} {b}x{s}x{h}x{d}"] = {k: row[k] for k in (
            "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tflops")}
    torch.cuda.empty_cache()
    return out


def phase_serve_mesh(torch, kernels):
    """Serving under a mesh on one card (module docstring, item 19).
    Returns the summary: the flash launches of the mesh runs and row 1 at
    the per-rank shapes."""
    t0 = time.perf_counter()
    card = gpu_line()
    one = sm_one_card(torch, kernels, card)
    kernel_rows = sm_kernel_rows(torch, kernels)
    summary = {"phase": "serve_mesh", "gpu": card,
               "seconds": time.perf_counter() - t0,
               "launches": one["launches"], "init_s": one["init_s"],
               "n_params": one["n_params"], "kernels": kernel_rows}
    emit(summary)
    dp_close()
    return summary


def sm_small_conf():
    from deeplearning4j_tpu_torch.models.zoo import char_transformer

    s = SM_SMALL
    return char_transformer(s["vocab"], d_model=s["d_model"],
                            n_blocks=s["n_blocks"], n_heads=s["n_heads"],
                            max_seq_len=s["seq"])


def sm_small_tokens(net) -> dict:
    """The f32 small net's greedy tokens of SM_SMALL's prompt, dense and
    paged (its warm-up first)."""
    s = SM_SMALL
    out = {}
    for name, opts in (("dense", {}), ("paged", {"page_size":
                                                 s["page_size"]})):
        net.warmup_generate(slots=2, max_seq=s["seq"],
                            prompt_buckets=(s["bucket"],), **opts)
        toks, _, _ = batcher_streams(None, net, [s["prompt"]], [0.0],
                                     s["new"], 2, s["seq"], (s["bucket"],),
                                     **opts)
        out[name] = toks[0]
    return out


def sm_logp_at(torch, net, prompt, toks, j):
    """The logp after `prompt` + toks[:j] teacher-forced through one
    `prefill_logp` of a max_seq-wide bucket (on every rank of a mesh)."""
    seq = list(prompt) + list(toks[:j])
    p = np.zeros((1, SM["max_seq"]), np.int32)
    p[0, :len(seq)] = seq
    ic = net.infer_cache
    state = ic.decode_state(net.conf, 1, SM["max_seq"], net.device, "probe")
    logp, _ = ic.prefill_logp(net.conf, net.params, state, p,
                              np.asarray([len(seq)], np.int32))
    return logp[0].float().cpu()


def sm_ranks(torch, kernels) -> int:
    """Serving under a mesh on the cards of a torchrun group (`torchrun
    --nproc-per-node 4 chip_smoke.py --only-serve-mesh`): the one-card
    reference on rank 0 alone (the flagship's output and greedy streams,
    the small f32 net's tokens), then each layout of
    SM_LAYOUTS: every rank builds the flagship from seed 0 and
    `set_serve_mesh`; rank 0 serves while the others follow. The bf16
    output against the f32 net of the same params on one card, within
    SM_BF16_REACH times one card's own bf16 gap to it (each rank rounds
    its partial products to bf16 before their sum: a second bf16 error of
    the same size, about sqrt(2) times one; the gap to one card and
    whether it is within 2e-2 max|o| are reported); the greedy streams' first
    divergence and its logp gap within 2e-2 max|logp| (teacher-forced);
    the small f32 net's greedy tokens identical; latency, tokens/s and
    per-rank bytes. Then each control of SM_CONTROLS at
    SM_CONTROL_LAYOUT, whose output must break the output gate. Rank 0
    prints the lines and checks."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed

    t_all = time.perf_counter()
    init_distributed(SM_DEVICE)
    rank, world = dist.get_rank(), dist.get_world_size()
    lead = rank == 0
    card = gpu_line() if lead else None
    conf = gen_conf(SLICE["n_blocks"])
    prompts, _ = sm_requests()
    greedy = [0.0] * len(prompts)
    x = np.random.RandomState(3).randint(
        0, SLICE["vocab"], (SM["rows"], SLICE["seq"])).astype(np.int32)
    ref = None
    if lead:
        net, init_s = sm_net(torch, conf)
        out = net.output(torch.as_tensor(x, device=net.device)).float()
        toks, r = sm_pass(torch, kernels, net, prompts, greedy)
        f32_net, _ = sm_net(torch, gen_conf(SLICE["n_blocks"], None))
        out_f32 = f32_net.output(torch.as_tensor(x, device=net.device))
        out_f32 = out_f32.float().cpu()
        bf16_gap = float((out.cpu() - out_f32).abs().max())
        del f32_net
        small, _ = sm_net(torch, sm_small_conf())
        ref = {"out": out.cpu(), "streams": toks, "net": net,
               "bf16_vs_f32": bf16_gap, "out_f32": out_f32,
               "small": sm_small_tokens(small), "pass": r,
               "bytes": sm_bytes(torch, net), "init_s": init_s}
        emit({"phase": "serve_mesh_one_card_reference", "gpu": card,
              "init_s": init_s, "pass": r, "bytes": ref["bytes"],
              "output_bf16_vs_f32_max_abs": bf16_gap,
              "output_ms": sm_output_ms(torch, net, torch.as_tensor(
                  x, device=net.device))})
        del small
    dist.barrier()
    fails = []
    for b, m in SM_LAYOUTS:
        t0 = time.perf_counter()
        spec = f"batch={b},model={m}"
        net, init_s = sm_net(torch, conf)
        net.set_serve_mesh(spec=spec)
        small, _ = sm_net(torch, sm_small_conf())
        small.set_serve_mesh(spec=spec)
        if not lead:
            net.follow()
            small.follow()
            del net, small
            dp_free(torch)
            continue
        xt = torch.as_tensor(x, device=net.device)
        out = net.output(xt).float().cpu()
        out_err = float((out - ref["out"]).abs().max())
        vs_f32 = float((out - ref["out_f32"]).abs().max())
        out_tol = SM_BF16_REACH * ref["bf16_vs_f32"]
        rel_tol = 2e-2 * float(ref["out"].abs().max())
        out_ms = sm_output_ms(torch, net, xt)
        toks, r = sm_pass(torch, kernels, net, prompts, greedy)
        divergences = []
        for i, (a, got) in enumerate(zip(ref["streams"], toks)):
            if a == got:
                continue
            j = next(k for k, (u, v) in enumerate(zip(a, got)) if u != v)
            want_lp = sm_logp_at(torch, ref["net"], prompts[i], a, j)
            got_lp = sm_logp_at(torch, net, prompts[i], a, j)
            divergences.append({"request": i, "token": j,
                                "logp_gap": float((got_lp - want_lp).abs()
                                                  .max()),
                                "max_abs_logp": float(want_lp.abs().max())})
        bytes_ = sm_bytes(torch, net)
        net.stop_followers()
        small_toks = sm_small_tokens(small)
        small.stop_followers()
        row = {"phase": "serve_mesh_layout", "gpu": card,
               "layout": {"batch": b, "model": m}, "init_s": init_s,
               "output_vs_one_card_max_abs": out_err,
               "output_within_2e-2_max": out_err <= rel_tol,
               "output_vs_f32_max_abs": vs_f32,
               "one_card_vs_f32_max_abs": ref["bf16_vs_f32"],
               "output_vs_f32_tol": out_tol,
               "output_ms": out_ms, "pass": r,
               "streams_equal_one_card": sum(
                   a == t for a, t in zip(ref["streams"], toks)),
               "divergences": divergences,
               "small_f32_tokens_identical": small_toks == ref["small"],
               "bytes_rank0": bytes_,
               "one_card_bytes": ref["bytes"],
               "seconds": time.perf_counter() - t0}
        emit(row)
        if vs_f32 > out_tol:
            fails.append(f"{spec}: output {vs_f32} from f32, over "
                         f"{SM_BF16_REACH} x one card's {ref['bf16_vs_f32']}")
        fails += [f"{spec}: divergence {d}" for d in divergences
                  if d["logp_gap"] > 2e-2 * d["max_abs_logp"]]
        if small_toks != ref["small"]:
            fails.append(f"{spec}: f32 tokens {small_toks} vs "
                         f"{ref['small']}")
        if bytes_["kv_table"] * m != ref["bytes"]["kv_table"]:
            fails.append(f"{spec}: K/V bytes {bytes_} vs one card's "
                         f"{ref['bytes']}")
        del net, small
        dp_free(torch)
    b, m = SM_CONTROL_LAYOUT
    for name in SM_CONTROLS:
        with sm_control(name):
            net, _ = sm_net(torch, conf)
            net.set_serve_mesh(spec=f"batch={b},model={m}")
            if not lead:
                net.follow()
            else:
                out = net.output(torch.as_tensor(x, device=net.device))
                vs_f32 = float((out.float().cpu() - ref["out_f32"])
                               .abs().max())
                net.stop_followers()
                tol = SM_BF16_REACH * ref["bf16_vs_f32"]
                emit({"phase": "serve_mesh_control", "gpu": card,
                      "control": name, "layout": {"batch": b, "model": m},
                      "output_vs_f32_max_abs": vs_f32,
                      "reach": vs_f32 / ref["bf16_vs_f32"],
                      "output_vs_f32_tol": tol})
                if vs_f32 <= tol:
                    fails.append(f"control {name}: output {vs_f32} from "
                                 f"f32 is within the gate {tol}")
        del net
        dp_free(torch)
    if lead:
        emit({"phase": "serve_mesh_ranks", "gpu": card, "ranks": world,
              "fails": fails, "seconds": time.perf_counter() - t_all})
        print(card, flush=True)
    ok = [not fails]
    dist.broadcast_object_list(ok, src=0)
    dp_close()
    check(ok[0], "; ".join(fails) or "serve_mesh: rank 0 failed")
    return 0


# -- serving precision --------------------------------------------------------

#: the flagship from seed 0 with f32 compute, served under each policy on
#: `rows` x SLICE seq ids; its generation is the serve_mesh phase's (SM's
#: slots, max_seq, prompt buckets and prompts), greedy; `cli_requests`
#: requests to the CLI's server
SP = dict(rows=4, seed=0, cli_requests=2)
SP_POLICIES = ("f32", "bf16", "int8")
#: the flash forward's body by policy: the 3xTF32 one on the f32 conf's
#: float32 operands, the TMA bf16 one where the policy computes in bf16
SP_FLASH_BODY = {"f32": "flash_fwd_3xtf32_kernel",
                 "bf16": "flash_fwd_tma_kernel",
                 "int8": "flash_fwd_tma_kernel"}
#: the char-LSTM under a policy (the cell kernel) against the same policy's
#: hoisted scan: max|o - o_scan| over max|o_scan|
SP_LSTM_TOL = 2e-2
#: where the phase runs ("cpu" rehearses it at tiny sizes)
SP_DEVICE = "cuda"


def sp_device_flags():
    """The CLI's --device flag where the phase is rehearsed off the card."""
    return [] if SP_DEVICE == "cuda" else ["--device", SP_DEVICE]


def sp_numpy_quantize(w, clip):
    """The JAX package's `_quantize_leaf` in numpy (its own arithmetic:
    abs-max per output channel, float32 scale, `np.rint`, +-127)."""
    axis = 0 if w.ndim == 4 else w.ndim - 1
    red = tuple(a for a in range(w.ndim) if a != axis)
    amax = np.max(np.abs(w), axis=red, keepdims=True)
    scale = np.where(amax > 0.0, amax * clip / 127.0, 1.0).astype(np.float32)
    return np.clip(np.rint(w / scale), -127, 127).astype(np.int8), scale


def sp_quantized_bitwise(torch, net) -> dict:
    """Every int8 leaf the infer cache serves against `sp_numpy_quantize`
    of the card's param at the calibrated clip."""
    clip = net.serve_precision_report["calibration"]["clip"]
    leaves, q_off, scale_off = 0, 0, 0
    for layer, qlayer in zip(net.params, net.infer_cache._qparams):
        for name, leaf in qlayer.items():
            if not isinstance(leaf, dict):
                continue
            q, scale = sp_numpy_quantize(
                layer[name].detach().float().cpu().numpy(), clip)
            leaves += 1
            q_off += int((leaf["q"].cpu().numpy() != q).sum())
            scale_off += int((leaf["scale"].cpu().numpy() != scale).sum())
    return {"clip": clip, "leaves": leaves, "q_differing": q_off,
            "scale_differing": scale_off,
            "bitwise": q_off == 0 and scale_off == 0}


def sp_bytes(tree) -> int:
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def sp_within(delta) -> bool:
    from deeplearning4j_tpu_torch.models.zoo import PRECISION_ERROR_BUDGETS

    budget = PRECISION_ERROR_BUDGETS["char_transformer"][delta["policy"]]
    return all(delta[k] <= v for k, v in budget.items())


def sp_held_out_delta(net, policy) -> dict:
    """`accuracy_delta` of the served policy on `default_calibration(seed=
    1)`, held out from the int8 calibration batch (seed 0, which
    `set_serve_precision`'s own report measures on, as the JAX package's
    does)."""
    from deeplearning4j_tpu_torch.optimize import quantize

    x = net._input(quantize.default_calibration(net.conf, seed=1))
    return quantize.accuracy_delta(
        net.conf, net.params, x, policy,
        qparams=net.infer_cache._qparams if policy == "int8" else None)


def sp_flagship(torch, kernels, net, x, card) -> dict:
    """`output` under f32, bf16 and int8, then f32 again: the flash
    launches and body of each forward, the int8 leaves bitwise numpy's, the
    flip back bitwise and uncaptured, every policy in `programs_summary`;
    per policy the replay's ms, its device ms, the pool bytes its capture
    added, the resident param bytes and the accuracy delta on a held-out
    batch."""
    ic = net.infer_cache
    nb = SLICE["n_blocks"]
    rows, outs = {}, {}
    for policy in SP_POLICIES:
        pool0 = ic.pool.reserved_bytes
        torch.cuda.synchronize()
        t = time.perf_counter()
        report = net.set_serve_precision(policy)
        torch.cuda.synchronize()
        set_s = time.perf_counter() - t
        kernels.reset_launches()
        out = net.output(x)
        torch.cuda.synchronize()
        flash = kernels.LAUNCHES["flash_attn_fwd"]
        outs[policy] = out
        prof = profiled(torch, kernels, lambda: net.output(x),
                        f"serve_precision_output_{policy}")
        bodies = sorted({k["name"] for k in prof["port_kernels"]})
        row = {"policy": policy, "set_s": set_s, "report": report,
               "flash_launches": flash, "flash_bodies": bodies,
               "output_ms": sm_output_ms(torch, net, x),
               "output_device_ms": prof["device_ms"],
               "pool_bytes": ic.pool.reserved_bytes - pool0,
               "param_bytes": sp_bytes(ic._serve_params(net.params)),
               "finite": bool(torch.isfinite(out).all()),
               "shape": list(out.shape)}
        if policy != "f32":
            row["accuracy_delta_held_out"] = sp_held_out_delta(net, policy)
            row["within_budget"] = sp_within(row["accuracy_delta_held_out"])
        if policy == "int8":
            row["quantized"] = sp_quantized_bitwise(torch, net)
            check(row["quantized"]["bitwise"], "serve_precision: the int8 "
                  "leaves are not numpy's quantization of the params")
        emit({"phase": "serve_precision_output", "gpu": card, **row})
        check(row["finite"] and row["shape"] == [SP["rows"] * SLICE["seq"],
                                                 SLICE["vocab"]],
              f"serve_precision {policy}: output {row['shape']} not finite "
              f"or misshapen")
        check(flash == nb, f"serve_precision {policy}: {flash} flash "
              f"launches a forward, want {nb}")
        check(any(SP_FLASH_BODY[policy] in b for b in bodies),
              f"serve_precision {policy}: the flash body was {bodies}, "
              f"want {SP_FLASH_BODY[policy]}")
        rows[policy] = row
    misses = ic.stats.misses
    net.set_serve_precision("f32")
    kernels.reset_launches()
    back = net.output(x)
    torch.cuda.synchronize()
    flip = {"bitwise": bool(torch.equal(back, outs["f32"])),
            "captured": ic.stats.misses - misses,
            "flash_launches": kernels.LAUNCHES["flash_attn_fwd"],
            "policies": sorted({r["policy"] for r in ic.programs_summary()})}
    emit({"phase": "serve_precision_flip_back", "gpu": card, **flip})
    check(flip["bitwise"] and flip["captured"] == 0,
          f"serve_precision: the flip back to f32 {flip}")
    check(flip["policies"] == sorted(SP_POLICIES),
          f"serve_precision: programs_summary lists {flip['policies']}")
    launches = sum(r["flash_launches"] for r in rows.values()) \
        + flip["flash_launches"]
    return {"rows": rows, "flip": flip, "flash_launches": launches,
            "int8_out": outs["int8"]}


def sp_generation(torch, kernels, net, card) -> dict:
    """`warmup_generate`, then SM's 4-slot batcher over its 4 prompts, 32
    greedy tokens each, under bf16 and int8 (its weights a disk hit):
    nothing captured while serving, one flash launch a block an admission;
    tokens/s and one captured decode step's device ms (profiled)."""
    ic = net.infer_cache
    nb = SLICE["n_blocks"]
    prompts, _ = sm_requests()
    temps = [0.0] * len(prompts)
    rows = {}
    for policy in ("bf16", "int8"):
        rep = net.set_serve_precision(policy, measure=False)
        pool0 = ic.pool.reserved_bytes
        toks, r = sm_pass(torch, kernels, net, prompts, temps)
        slots = SM["slots"]
        table = ic.decode_state(net.conf, slots, SM["max_seq"], net.device,
                                "table")
        zeros = torch.zeros((slots,), dtype=torch.int32, device=net.device)
        keys = torch.zeros((slots, 2), dtype=torch.int64, device=net.device)
        temps_t = torch.zeros((slots,), device=net.device)
        prof = profiled(torch, kernels, lambda: ic.decode(
            net.conf, net.params, table, zeros, zeros, keys, temps_t),
            f"serve_precision_decode_{policy}")
        r.update(policy=policy, artifact=rep.get("artifact"),
                 decode_device_ms=prof["device_ms"],
                 decode_wall_ms=prof["wall_ms"],
                 pool_bytes=ic.pool.reserved_bytes - pool0,
                 stream_lengths=[len(t) for t in toks])
        emit({"phase": "serve_precision_generate", "gpu": card, **r})
        flash = r["launches"]["flash_attn_fwd"]
        check(flash == nb * len(prompts), f"serve_precision generate "
              f"{policy}: {flash} flash launches, want {nb * len(prompts)}")
        check(r["captured_while_serving"] == 0, f"serve_precision generate "
              f"{policy}: captured while serving")
        check(all(n == SM["new"] for n in r["stream_lengths"]),
              f"serve_precision generate {policy}: streams "
              f"{r['stream_lengths']}")
        rows[policy] = r
    return {"rows": rows, "flash_launches": sum(
        r["launches"]["flash_attn_fwd"] for r in rows.values())}


def sp_lstm(torch, kernels, card) -> dict:
    """The bench's 4-layer char-LSTM with f32 compute under bf16 and int8:
    the cell kernel's launches (T a layer a forward) and its body (bf16),
    and the output against the same policy's hoisted scan on the card
    (the scan net serves the kernel net's int8 weights)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    lnet = MultiLayerNetwork(lstm_conf("auto", None), device=SP_DEVICE,
                             seed=0).init()
    snet = MultiLayerNetwork(lstm_conf("scan", None), device=SP_DEVICE)
    snet.params = tuple({k: v.clone() for k, v in lay.items()}
                        for lay in lnet.params)
    x = torch.as_tensor(lstm_batch()[0], device=SP_DEVICE)
    want = LSTM["n_layers"] * LSTM["seq"]
    rows = {}
    for policy in ("bf16", "int8"):
        lnet.set_serve_precision(policy, measure=False)
        if policy == "int8":
            snet.infer_cache.set_policy("int8", lnet.infer_cache._qparams)
        else:
            snet.set_serve_precision(policy, measure=False)
        kernels.reset_launches()
        out = lnet.output(x)
        torch.cuda.synchronize()
        n = kernels.LAUNCHES["lstm_cell"]
        prof = profiled(torch, kernels, lambda: lnet.output(x),
                        f"serve_precision_lstm_{policy}", "lstm_cell")
        ref = snet.output(x)
        gap = float((out - ref).abs().max() / ref.abs().max())
        row = {"policy": policy, "launches": n,
               "bodies": sorted({k["name"] for k in prof["port_kernels"]}),
               "gap_to_scan": gap, "output_device_ms": prof["device_ms"],
               "output_ms": sm_output_ms(torch, lnet, x)}
        emit({"phase": "serve_precision_lstm", "gpu": card, **row})
        check(n == want, f"serve_precision lstm {policy}: {n} cell "
              f"launches a forward, want {want}")
        check(any("lstm_cell_bf16_kernel" in b for b in row["bodies"]),
              f"serve_precision lstm {policy}: bodies {row['bodies']}")
        check(gap <= SP_LSTM_TOL, f"serve_precision lstm {policy}: gap "
              f"{gap} to the scan")
        rows[policy] = row
    del lnet, snet
    dp_free(torch)
    return {"rows": rows, "launches": sum(r["launches"]
                                          for r in rows.values())}


def sp_budgets(torch, card) -> dict:
    """`error_budget_report(small=False)` on the card: the JAX package's
    full-size eval confs."""
    from deeplearning4j_tpu_torch.optimize import quantize

    t = time.perf_counter()
    report = quantize.error_budget_report(small=False, device=SP_DEVICE)
    row = {model: {p: {k: d[k] for k in ("top1_delta", "rel_mse",
                                          "within_budget", "budget")}
                   for p, d in entry.items()}
           for model, entry in report.items()}
    emit({"phase": "serve_precision_budgets", "gpu": card, "report": row,
          "seconds": time.perf_counter() - t})
    bad = [(m, p) for m, e in row.items() for p, d in e.items()
           if not d["within_budget"]]
    check(not bad, f"serve_precision: error budgets exceeded: {bad}")
    return row


def sp_child_run(workdir) -> int:
    """The store's second process (`--sp-child DIR`): the flagship from
    seed 0 on DIR/store, int8 from the stored artifact, its output saved
    for the parent, and the parent's prefix prompt through a batcher with
    the prefix cache (a disk hit). Prints one JSON line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.nd import kernels
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    net = MultiLayerNetwork(gen_conf(SLICE["n_blocks"], None),
                            device=SP_DEVICE, seed=SP["seed"]).init()
    store = net.set_compile_cache(os.path.join(workdir, "store"))
    rep = net.set_serve_precision("int8", measure=False)
    x = torch.as_tensor(np.load(os.path.join(workdir, "x.npy")),
                        device=SP_DEVICE)
    np.save(os.path.join(workdir, "child_int8.npy"),
            net.output(x).cpu().numpy())
    with open(os.path.join(workdir, "prefix.json")) as f:
        prompt = json.load(f)
    toks, stats, _ = batcher_streams(
        torch, net, [prompt], [0.0], SM["new"], SM["slots"], SM["max_seq"],
        SM["buckets"], prefix_cache=True)
    emit({"artifact": rep["artifact"], "calibration": rep["calibration"],
          "tokens": toks[0], "prefix_cache": stats["prefix_cache"],
          "store": store.stats()})
    return 0


def sp_child(workdir) -> dict:
    """`chip_smoke.py --sp-child DIR` in a process of its own; its line."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--sp-child", workdir], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"serve_precision child failed: "
          f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sp_store(torch, kernels, net, x, int8_out, card, workdir) -> dict:
    """The store on the flagship: the int8 artifact in a second process (a
    disk hit, no calibration, output bitwise this process's), the prefix
    disk store (the child serves this process's prompt from disk with its
    tokens), a corrupted artifact evicted and calibrated again."""
    store = net.infer_cache.persist
    prompts, _ = sm_requests()
    net.set_serve_precision("int8", measure=False)
    toks, stats, _ = batcher_streams(
        torch, net, prompts[:1], [0.0], SM["new"], SM["slots"],
        SM["max_seq"], SM["buckets"], prefix_cache=True)
    np.save(os.path.join(workdir, "x.npy"), x.cpu().numpy())
    with open(os.path.join(workdir, "prefix.json"), "w") as f:
        json.dump(prompts[0], f)
    t = time.perf_counter()
    child = sp_child(workdir)
    child_s = time.perf_counter() - t
    child_out = np.load(os.path.join(workdir, "child_int8.npy"))
    row = {"child_s": child_s, "child_artifact": child["artifact"],
           "child_output_bitwise": bool(np.array_equal(
               child_out, int8_out.cpu().numpy())),
           "prefix_writer": stats["prefix_cache"],
           "prefix_reader": child["prefix_cache"],
           "prefix_tokens_identical": child["tokens"] == toks[0],
           "store": store.stats()}
    # a corrupted artifact: evicted, calibrated again
    entries = len(store)
    evicted = store.corrupt_evicted
    from deeplearning4j_tpu_torch.optimize import quantize

    art = store.path_for(quantize.quantize_artifact_key(
        net.infer_cache._fingerprint(net.conf),
        quantize.params_digest(net.params)))
    with open(art, "r+b") as f:
        f.seek(-16, os.SEEK_END)
        f.write(b"\xff" * 16)
    rep = net.set_serve_precision("int8", measure=False)
    row["corrupt"] = {"entries": entries, "artifact": rep["artifact"],
                      "corrupt_evicted": store.corrupt_evicted - evicted}
    emit({"phase": "serve_precision_store", "gpu": card, **row})
    check(child["artifact"]["source"] == "disk",
          f"serve_precision: the child calibrated: {child['artifact']}")
    check(row["child_output_bitwise"], "serve_precision: the child's int8 "
          "output differs")
    check(child["prefix_cache"]["disk_hits"] == 1
          and row["prefix_tokens_identical"],
          f"serve_precision: the prefix disk entry {row['prefix_reader']}")
    check(rep["artifact"]["source"] == "calibrated"
          and row["corrupt"]["corrupt_evicted"] == 1,
          f"serve_precision: the corrupt artifact {row['corrupt']}")
    return row


def sp_cli(torch, net, card, workdir) -> dict:
    """`warmup --precision int8 --compile-cache D --shapes 4x512` in
    process, then `serve --precision int8 --compile-cache D --shapes 4x512`
    as a subprocess and SP["cli_requests"] POST /v1/predict of one row
    each: its int8 weights come from the artifact, `/v1/stats` shows int8,
    and no request captured (`fresh_compiles` as at startup)."""
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.parallel import checkpoint

    ckpt = os.path.join(workdir, "ckpt")
    cache = os.path.join(workdir, "cli_store")
    t = time.perf_counter()
    checkpoint.save(ckpt, net.params, conf=net.conf)
    save_s = time.perf_counter() - t
    shapes = f"{SP['rows']}x{SLICE['seq']}"
    t = time.perf_counter()
    rc, warm = cli_json(cli_main, ["warmup", "--model", ckpt,
                                   "--compile-cache", cache, "--shapes",
                                   shapes, "--precision", "int8",
                                   *sp_device_flags()])
    warm_s = time.perf_counter() - t
    check(rc == 0, "serve_precision: cli warmup failed")
    xs = [np.random.RandomState(20 + i).randint(
        0, SLICE["vocab"], (1, SLICE["seq"])).astype(np.int32)
        for i in range(SP["cli_requests"])]
    served, answers = cli_serve(torch, ckpt, xs,
                                ["interactive"] * SP["cli_requests"], shapes,
                                extra=["--precision", "int8",
                                       "--compile-cache", cache,
                                       *sp_device_flags()])
    startup, stats = served["startup"], served["stats"]
    row = {"save_s": save_s, "warmup_s": warm_s,
           "warmup_artifact": warm["precision_report"]["artifact"],
           "serve_start_s": served["start_s"],
           "serve_artifact": startup["precision_report"]["artifact"],
           "fresh_compiles_startup": startup["fresh_compiles"],
           "fresh_compiles_after": stats["fresh_compiles"],
           "stats_precision": {k: stats["precision"][k] for k in (
               "policy", "rows_by_policy")},
           "latency_ms": served["latency_ms"],
           "answers_finite": all(bool(np.isfinite(a).all())
                                 for a in answers)}
    emit({"phase": "serve_precision_cli", "gpu": card, **row})
    check(startup["precision_report"]["artifact"]["source"] == "disk"
          and startup["precision_report"]["calibration"]
          == warm["precision_report"]["calibration"],
          f"serve_precision cli: serve calibrated: {row}")
    check(stats["precision"]["policy"] == "int8"
          and row["fresh_compiles_after"] <= row["fresh_compiles_startup"]
          and row["answers_finite"], f"serve_precision cli: {row}")
    return row


def phase_serve_precision(torch, kernels):
    """Serving precision (module docstring, item 20). Returns the summary:
    the flash and cell launches of the policies' runs and their bodies."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t0 = time.perf_counter()
    card = gpu_line()
    workdir = tempfile.mkdtemp(prefix="serve_precision_")
    try:
        net = MultiLayerNetwork(gen_conf(SLICE["n_blocks"], None),
                                device=SP_DEVICE, seed=SP["seed"]).init()
        net.set_compile_cache(os.path.join(workdir, "store"))
        x = torch.as_tensor(np.random.RandomState(3).randint(
            0, SLICE["vocab"], (SP["rows"], SLICE["seq"])).astype(np.int32),
            device=SP_DEVICE)
        flag = sp_flagship(torch, kernels, net, x, card)
        gen = sp_generation(torch, kernels, net, card)
        store = sp_store(torch, kernels, net, x, flag["int8_out"], card,
                         workdir)
        cli = sp_cli(torch, net, card, workdir)
        del net
        dp_free(torch)
        lstm = sp_lstm(torch, kernels, card)
        budgets = sp_budgets(torch, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    summary = {"phase": "serve_precision", "gpu": card,
               "seconds": time.perf_counter() - t0,
               "flash_launches": flag["flash_launches"]
               + gen["flash_launches"],
               "flash_by_policy": {
                   p: {"output_launches": r["flash_launches"],
                       "bodies": r["flash_bodies"]}
                   for p, r in flag["rows"].items()},
               "generate_flash_launches": {
                   p: r["launches"]["flash_attn_fwd"]
                   for p, r in gen["rows"].items()},
               "lstm_launches": lstm["launches"],
               "lstm_by_policy": {p: {"launches": r["launches"],
                                      "bodies": r["bodies"]}
                                  for p, r in lstm["rows"].items()},
               "store": {k: store[k] for k in ("child_artifact",
                                               "child_output_bitwise")},
               "cli": {k: cli[k] for k in ("serve_artifact",
                                           "fresh_compiles_after")},
               "budgets": budgets}
    emit(summary)
    return summary


#: the fleet phase (item 21): the flagship at SLICE's widths cut to
#: FL["n_blocks"] blocks (bf16 compute), the tile-variant cases, the
#: requests through the router and the tune's decode sweep length
FL = dict(n_blocks=2, seed=0, requests=4, burst=16, burst_threads=8,
          heal_requests=2, agent_requests=2, gen_max_seq=64, rounds=2,
          timeout_s=300.0)
FL_DEVICE = "cuda"
#: the serve group's row candidates (`batcher.target_rows`' space)
FL_SERVE_ROWS = (64, 128, 256, 512, 1024)

#: the forward's tile-variant cases: (b, s, h, d, dtype, causal, with_lse,
#: view), each run at every tile its body is built with: bf16 at the train
#: shape (on qkv views, with lse) and the prefill shapes (causal, views),
#: a D = 64 case for the bf16 D = 64 bodies; f32 at [8, 512, 16, 128]
#: causal and not, with lse, and at D = 64
FL_TILE_CASES = (
    ("bfloat16", (32, 512, 16, 128, True, True, True)),
    ("bfloat16", (1, 64, 16, 128, True, False, True)),
    ("bfloat16", (1, 256, 16, 128, True, False, True)),
    ("bfloat16", (8, 512, 16, 64, True, True, False)),
    ("float32", (8, 512, 16, 128, True, True, False)),
    ("float32", (8, 512, 16, 128, False, True, False)),
    ("float32", (8, 512, 16, 64, True, True, False)),
)


def fl_tile_row(torch, kernels, gen, dname, case, tile):
    """One forward case at one tile variant against the plain version (bf16
    within 2e-2 of max|o|, its lse 1e-3; f32 1e-4 on o and lse), timed by
    graph replay beside the plain version and SDPA, with its bound. Emits
    and returns the row; a disagreement fails the run."""
    import torch.nn.functional as F

    b, s, h, d, causal, with_lse, view = case
    dt = getattr(torch, dname)
    q, k, v = fwd_inputs(torch, gen, b, s, h, d, dt, view)

    def run():
        return kernels.flash_attn_fwd(q, k, v, causal, with_lse=with_lse,
                                      tile=tile)

    before = dict(kernels.TILE_LAUNCHES)
    got = run()
    want = kernels.flash_attention_reference(q, k, v, causal,
                                             with_lse=with_lse)
    torch.cuda.synchronize()
    name = kernels.tile_name(dt, tile)
    check(kernels.TILE_LAUNCHES[name] == before[name] + 1,
          f"fleet: the {name} variant did not launch")
    if not with_lse:
        got, want = (got, None), (want, None)
    err_o = (got[0].float() - want[0].float()).abs().max().item()
    if dt == torch.float32:
        tol = 1e-4
        ok = bool(torch.allclose(got[0], want[0], atol=1e-4, rtol=1e-4))
    else:
        tol = 2e-2 * want[0].float().abs().max().item()
        ok = err_o <= tol
    err_lse = None
    if with_lse:
        err_lse = (got[1] - want[1]).abs().max().item()
        lse_tol = 1e-4 if dt == torch.float32 else 1e-3
        ok = ok and bool(torch.allclose(got[1], want[1], atol=lse_tol,
                                        rtol=lse_tol))
    del got, want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel_ms = graph_ms(run)
    plain_ms = graph_ms(lambda: kernels.flash_attention_reference(
        q, k, v, causal, with_lse=with_lse), iters=5, replays=1)
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    bound_ms, bound_by, fma_bound_ms = attention_bound_ms(
        b, s, h, d, dname, causal, with_lse)
    flops = 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)
    row = {"phase": "fleet_tile", "name": "flash_attn_fwd", "tile": name,
           "shape": [b, s, h, d], "dtype": dname, "causal": causal,
           "with_lse": with_lse, "view": view, "max_abs_err": err_o,
           "tol": tol, "max_abs_err_lse": err_lse, "ok": bool(ok),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "fma_bound_ms": fma_bound_ms,
           "tflops": flops / kernel_ms / 1e9}
    emit(row)
    check(ok, f"fleet: a flash tile variant disagrees with its plain "
              f"version: {row}")
    return row


def fl_tile_rows(torch, kernels):
    """Every FL_TILE_CASES case at every tile its body is built with; their
    launches are made to compare and time, not by the fleet's path."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    saved = kernels.launch_snapshot()
    rows = []
    for dname, case in FL_TILE_CASES:
        for tile in kernels.fwd_tiles(getattr(torch, dname), case[3]):
            rows.append(fl_tile_row(torch, kernels, gen, dname, case, tile))
        torch.cuda.empty_cache()
    kernels.reset_launches()
    kernels.count_launches(saved)
    return rows


def fl_conf():
    """The flagship at SLICE's widths, FL's depth, bf16 compute."""
    return gen_conf(FL["n_blocks"], "bfloat16")


def fl_rows(seed, n, rows=1):
    """`n` requests of `rows` rows of ids each, from `seed`."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SLICE["vocab"], (rows, SLICE["seq"]))
            .astype(np.int32) for _ in range(n)]


def fl_post(url, x, timeout=120.0):
    """POST /v1/predict of int32 ids: (status, the output as float32 or
    the error body)."""
    body = {"features": x.tolist(), "dtype": "int32"}
    req = urllib.request.Request(url + "/v1/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, np.asarray(json.loads(resp.read())["output"],
                                           np.float32)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def fl_spawn(args, what):
    """A port CLI subprocess (`python -m deeplearning4j_tpu_torch.cli
    ARGS`): (process, its first stdout line as JSON, seconds to it, the
    reader's list of its lines). The first line must come within FL's
    timeout."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *args]
    if FL_DEVICE != "cuda" and args[0] != "agent":
        cmd += ["--device", FL_DEVICE]
    env = dict(os.environ, PYTHONPATH=root)
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env,
                            cwd=root)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    while not lines and proc.poll() is None \
            and time.perf_counter() - t < FL["timeout_s"]:
        time.sleep(0.05)
    if not lines:
        proc.kill()
        proc.wait()
        check(False, f"fleet: {what} printed no startup line (exit "
                     f"{proc.poll()})")
    return proc, json.loads(lines[0]), time.perf_counter() - t, lines


def fl_stop(proc, lines, what, sig=None):
    """SIGTERM (or `sig`) a CLI subprocess and wait: its last JSON line;
    exit 0 required."""
    import signal

    proc.send_signal(signal.SIGTERM if sig is None else sig)
    try:
        proc.wait(timeout=FL["timeout_s"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    time.sleep(0.2)
    check(proc.returncode == 0, f"fleet: {what} exited {proc.returncode}")
    return json.loads(lines[-1])


def fl_tuning_ok(block, kind) -> bool:
    return (block is not None and block.get("tuned_tables") == 1
            and block.get("fresh_tunes") == 0
            and block.get("device_kind") == kind)


def fl_answers(url, xs, want, what):
    """Each of `xs` POSTed in turn through `url`: every answer a 200 bitwise
    `want`'s row (the same program on the same card). Returns (seconds,
    rows)."""
    t = time.perf_counter()
    for i, x in enumerate(xs):
        code, out = fl_post(url, x)
        check(code == 200, f"fleet: {what} request {i} answered {code}: "
                           f"{out}")
        check(out.shape == want[i].shape
              and np.array_equal(out, want[i]),
              f"fleet: {what} request {i} is not bitwise the in-process "
              f"output (max diff "
              f"{float(np.abs(out - want[i]).max()) if out.shape == want[i].shape else out.shape})")
    return time.perf_counter() - t, sum(x.shape[0] for x in xs)


def fl_burst(url, xs, want):
    """`xs` from FL's threads at once: rows/s through the router, and
    the largest gap from `want` (a coalesced batch pads other rows, so
    the gate is bf16's 2e-2 of max|o|, not bitwise)."""
    results = [None] * len(xs)

    def worker(idx):
        for i in idx:
            results[i] = fl_post(url, xs[i])

    n = FL["burst_threads"]
    threads = [threading.Thread(target=worker,
                                args=(range(j, len(xs), n),))
               for j in range(n)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(FL["timeout_s"])
    seconds = time.perf_counter() - t
    gap, scale = 0.0, 0.0
    for i, (code, out) in enumerate(results):
        check(code == 200, f"fleet: burst request {i} answered {code}")
        gap = max(gap, float(np.abs(out - want[i]).max()))
        scale = max(scale, float(np.abs(want[i]).max()))
    check(gap <= 2e-2 * scale, f"fleet: burst answers {gap} from the "
                               f"in-process rows (max|o| {scale})")
    rows = sum(x.shape[0] for x in xs)
    return {"seconds": seconds, "rows": rows, "rows_per_s": rows / seconds,
            "tokens_per_s": rows * SLICE["seq"] / seconds,
            "max_gap": gap, "max_abs": scale}


def fl_metrics(url):
    """The families of one `/metrics` scrape, parsed by the port's
    `parse_prometheus_text`."""
    from deeplearning4j_tpu_torch.serving.metrics import \
        parse_prometheus_text

    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    return parse_prometheus_text(text)


def fl_wait(url, cond, seconds):
    """/v1/stats of `url` polled until `cond(stats)`, or None after
    `seconds`."""
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        try:
            st = get_json(url + "/v1/stats")
        except Exception:  # noqa: BLE001 - the router is busy or healing
            st = None
        if st is not None and cond(st):
            return st
        time.sleep(0.2)
    return None


def fl_tune_f32(torch, kernels, workdir):
    """`tune --groups attention` of the f32-compute flagship (its params
    from the same seed) in process: the f32 body at each of its tiles.
    Returns the row; the table it installs is cleared after."""
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import tunables
    from deeplearning4j_tpu_torch.parallel import checkpoint

    ckpt = os.path.join(workdir, "ckpt_f32")
    net = MultiLayerNetwork(gen_conf(FL["n_blocks"], None), device=FL_DEVICE,
                            seed=FL["seed"]).init()
    checkpoint.save(ckpt, net.params, conf=net.conf)
    del net
    dev = [] if FL_DEVICE == "cuda" else ["--device", FL_DEVICE]
    kernels.reset_launches()
    rc, rep = cli_json(cli_main, ["tune", "--model", ckpt, "--compile-cache",
                                  os.path.join(workdir, "store_f32"),
                                  "--groups", "attention", "--rounds",
                                  str(FL["rounds"]), *dev])
    launches = kernels.launch_snapshot()
    tunables.clear()
    att = rep["groups"]["attention"]
    row = {"phase": "fleet_tune_f32", "tune_seconds": rep["tune_seconds"],
           "candidates_measured": rep["candidates_measured"],
           "entries": rep["entries"],
           "winners": {k: r["winner"] for k, r in att.items()},
           "attention_candidates_s": {k: r["candidates"]
                                      for k, r in att.items()},
           "launches": launches}
    emit(row)
    check(rc == 0 and rep["measure_failures"] == 0 and all(
        launches[kernels.tile_name(torch.float32, t)] > 0
        for t in kernels.fwd_tiles(torch.float32, 128)),
        f"fleet: the f32 tune did not launch every f32 tile: {row}")
    return row


def fl_tune(torch, kernels, ckpt, store):
    """`tune` on the checkpoint into the empty store, in process (its
    launches counted here), then again in a fresh process on the same
    store, which inherits the table."""
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main

    dev = [] if FL_DEVICE == "cuda" else ["--device", FL_DEVICE]
    kernels.reset_launches()
    t = time.perf_counter()
    rc, rep = cli_json(cli_main, ["tune", "--model", ckpt, "--compile-cache",
                                  store, "--rounds", str(FL["rounds"]),
                                  "--gen-max-seq", str(FL["gen_max_seq"]),
                                  *dev])
    wall = time.perf_counter() - t
    launches = kernels.launch_snapshot()
    check(rc == 0, "fleet: tune failed")
    gc.collect()
    torch.cuda.empty_cache()
    att = rep["groups"].get("attention", {})
    row = {"phase": "fleet_tune", "wall_s": wall,
           "tune_seconds": rep["tune_seconds"],
           "candidates_measured": rep["candidates_measured"],
           "candidates_pruned": rep["candidates_pruned"],
           "measure_failures": rep["measure_failures"],
           "entries": rep["entries"], "tuning": rep["tuning"],
           "winners": {g: {k: r["winner"] for k, r in grp.items()}
                       for g, grp in rep["groups"].items()},
           "attention_candidates_s": {k: r["candidates"]
                                      for k, r in att.items()},
           "serve_candidates_s": rep["groups"]["serve"][
               "batcher.target_rows"]["candidates"],
           "serve_pool_bytes": rep["groups"]["serve"][
               "batcher.target_rows"]["pool_bytes"],
           "decode_candidates_s": {k: r["candidates"] for k, r in
                                   rep["groups"].get("decode", {}).items()},
           "launches": launches}
    # a candidate that does not fit the card (1,024 rows of 512 ids: its
    # graph's pool is larger than the card) fails its capture: counted
    # and skipped, as any failed measurement; every other one is measured
    serve_failed = [str(c) for c in FL_SERVE_ROWS
                    if str(c) not in row["serve_candidates_s"]]
    row["serve_failed"] = serve_failed
    emit(row)
    check(rep["measure_failures"] == len(serve_failed)
          and set(serve_failed) <= {"1024"}
          and rep["tuning"]["tuned_tables"] == 1
          and rep["tuning"]["fresh_tunes"] > 0
          and rep["tuning"]["source"] == "fresh",
          f"fleet: tune's report: {row}")
    check(launches["flash_attn_fwd"] > 0 and all(
        launches[kernels.tile_name(torch.bfloat16, t)] > 0
        for t in kernels.fwd_tiles(torch.bfloat16, 128)),
        f"fleet: tune's attention group did not launch every bf16 tile: "
        f"{launches}")
    proc, again, again_s, lines = fl_spawn(
        ["tune", "--model", ckpt, "--compile-cache", store], "tune again")
    proc.wait(timeout=FL["timeout_s"])
    again_row = {"phase": "fleet_tune_again", "wall_s": again_s,
                 "tuning": again["tuning"],
                 "candidates_measured": again["candidates_measured"],
                 "entries": again["entries"]}
    emit(again_row)
    check(proc.returncode == 0 and again["tuning"]["fresh_tunes"] == 0
          and again["tuning"]["source"] == "disk"
          and again["candidates_measured"] == 0
          and again["entries"] == rep["entries"],
          f"fleet: the second tune did not inherit: {again_row}")
    return row, launches


def phase_fleet(torch, kernels):
    """Tuned tables and the serving fleet (module docstring, item 21).
    Returns the summary: the launch counts of the fleet's path."""
    import shutil
    import signal
    import tempfile

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import tunables
    from deeplearning4j_tpu_torch.parallel import checkpoint
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    t0 = time.perf_counter()
    card = gpu_line()
    kind = (torch.cuda.get_device_name(0) if FL_DEVICE == "cuda"
            else "cpu")
    bodies = {"tma": tma_ptxas(kernels)["flash_attn_fwd"],
              "f32": f32_ptxas(kernels)["flash_attn_fwd"]}
    emit({"phase": "fleet_build", "flash_attn_fwd_bodies": bodies})
    check_no_spills({"flash_attn_fwd": bodies["tma"]})
    check_no_spills({"flash_attn_fwd": bodies["f32"]}, ("32", "64", "128"),
                    "f32")
    tile_rows = fl_tile_rows(torch, kernels)
    workdir = tempfile.mkdtemp(prefix="fleet_")
    procs = []
    try:
        ckpt = os.path.join(workdir, "ckpt")
        store1 = os.path.join(workdir, "store1")
        store2 = os.path.join(workdir, "store2")
        f32_row = fl_tune_f32(torch, kernels, workdir)
        net = MultiLayerNetwork(fl_conf(), device=FL_DEVICE,
                                seed=FL["seed"]).init()
        checkpoint.save(ckpt, net.params, conf=net.conf)
        del net
        gc.collect()
        torch.cuda.empty_cache()
        tune_row, tune_launches = fl_tune(torch, kernels, ckpt, store1)
        # the in-process reference: the checkpoint with the same table
        # installed (the tune above installed it) and the same buckets
        ref = load_network(ckpt, device=FL_DEVICE)
        ref.set_compile_cache(store1)
        check(tunables.active() is not None, "fleet: no table installed")

        def expect(xs):
            return [np.asarray(ref.output(x).float().cpu().numpy(),
                               np.float32) for x in xs]

        # -- serve --replicas 2 --min-replicas 1 --max-replicas 2 ---------
        shapes = f"1x{SLICE['seq']}"
        router, up, start_s, lines = fl_spawn(
            ["serve", "--model", ckpt, "--compile-cache", store1,
             "--shapes", shapes, "--replicas", "2", "--min-replicas", "1",
             "--max-replicas", "2", "--port", "0", "--max-delay-ms", "2",
             "--drain-timeout", "30"], "serve --replicas 2")
        procs.append(router)
        url = up["url"]
        # each replica's stats and /metrics at once, before the
        # autoscaler (min 1) may scale an idle fleet down
        replica_stats = [get_json(u + "/v1/stats") for u in up["replicas"]]
        replica_families = fl_metrics(up["replicas"][0])
        tuned = [fl_tuning_ok(t, kind) for t in up["tuning"]] + [
            fl_tuning_ok(s.get("tuning"), kind) for s in replica_stats]
        check(len(up["replicas"]) == 2 and all(tuned),
              f"fleet: a replica did not inherit the table: "
              f"{up['tuning']}, {[s.get('tuning') for s in replica_stats]}")
        xs = fl_rows(31, FL["requests"])
        want = expect(xs)
        seq_s, seq_rows = fl_answers(url, xs, want, "router")
        burst_xs = fl_rows(32, FL["burst"])
        burst = fl_burst(url, burst_xs, expect(burst_xs))
        served_launches = fl_replica_launches(up["replicas"])
        router_families = fl_metrics(url)
        for fam in ("dl4j_router_requests_total",
                    "dl4j_router_replicas_healthy",
                    "dl4j_fleet_replicas", "dl4j_fleet_restarts_total"):
            check(fam in router_families, f"fleet: router /metrics lacks "
                                          f"{fam}")
        for fam in ("dl4j_serving_requests_total", "dl4j_tuning_table_info",
                    "dl4j_tuning_fresh_tunes_total"):
            check(fam in replica_families, f"fleet: replica /metrics lacks "
                                           f"{fam}")
        # -- SIGKILL one live replica: the supervisor respawns it ----------
        victims = [p for p in up["replica_pids"] if fl_alive(p)]
        check(bool(victims), "fleet: no live replica to kill")
        t = time.perf_counter()
        os.kill(victims[0], signal.SIGKILL)
        healed = fl_wait(url, lambda st: (
            (st.get("fleet") or {}).get("restarts_total", 0) >= 1
            and st.get("healthy_replicas", 0) >= 1
            and any(s["restarts"] >= 1 and s["state"] == "running"
                    for s in st["fleet"]["slots"])), FL["timeout_s"])
        heal_s = time.perf_counter() - t
        check(healed is not None, "fleet: the killed replica was not "
                                  "respawned")
        heal_xs = fl_rows(33, FL["heal_requests"])
        fl_answers(url, heal_xs, expect(heal_xs), "router after the heal")
        respawned = [s for s in healed["fleet"]["slots"]
                     if s["restarts"] >= 1]
        fleet_stats = get_json(url + "/v1/stats")
        drained = fl_stop(router, lines, "serve --replicas 2")
        procs.remove(router)
        check(drained["drained"] and drained["restarts"] >= 1 and all(
            rc == 0 for rc in drained["replica_exit_codes"]),
            f"fleet: the drain: {drained}")
        fleet_row = {
            "phase": "fleet_serve", "gpu": card, "start_s": start_s,
            "replicas": len(up["replicas"]),
            "startup_tuning": up["tuning"],
            "fresh_compiles": up["fresh_compiles"],
            "sequential": {"requests": len(xs), "seconds": seq_s,
                           "rows_per_s": seq_rows / seq_s,
                           "bitwise": True},
            "burst": burst,
            "served_kernel_launches": served_launches,
            "router_families": len(router_families),
            "replica_families": len(replica_families),
            "heal_s": heal_s, "respawned": respawned,
            "autoscaler": fleet_stats.get("autoscaler"),
            "retries": fleet_stats.get("retries"),
            "unroutable": fleet_stats.get("unroutable"),
            "drained": drained}
        emit(fleet_row)
        flash_served = sum(r.get("flash_attn_fwd", 0)
                           for r in served_launches)
        check(flash_served > 0, f"fleet: the replicas launched no flash "
                                f"forward: {served_launches}")
        # -- an agent on an empty store, warmed over the cachesync wire ---
        agent, agent_up, agent_s, agent_lines = fl_spawn(
            ["agent", "--compile-cache", store2, "--max-replicas", "1",
             "--port", "0", "--drain-timeout", "30"], "agent")
        procs.append(agent)
        remote, rup, rstart_s, rlines = fl_spawn(
            ["serve", "--model", ckpt, "--compile-cache", store1,
             "--shapes", shapes, "--agent", agent_up["url"], "--port", "0",
             "--max-delay-ms", "2", "--drain-timeout", "30"],
            "serve --agent")
        procs.append(remote)
        rstats = get_json(rup["url"] + "/v1/stats")
        slot = rstats["fleet"]["slots"][0]
        agent_xs = fl_rows(34, FL["agent_requests"])
        agent_seq_s, _ = fl_answers(rup["url"], agent_xs, expect(agent_xs),
                                    "the agent's replica")
        rdrained = fl_stop(remote, rlines, "serve --agent")
        procs.remove(remote)
        adrained = fl_stop(agent, agent_lines, "agent")
        procs.remove(agent)
        agent_row = {"phase": "fleet_agent", "agent_start_s": agent_s,
                     "serve_start_s": rstart_s, "tuning": rup["tuning"],
                     "slot": slot, "requests_s": agent_seq_s,
                     "store2_entries": len([n for n in os.listdir(store2)
                                            if n.endswith(".ptp")]),
                     "drained": rdrained, "agent_drained": adrained}
        emit(agent_row)
        check(fl_tuning_ok(rup["tuning"][0], kind)
              and (slot.get("cache_fetch_hits") or 0) >= 1,
              f"fleet: the agent's replica did not get the table over the "
              f"wire: {agent_row}")
    finally:
        # a router or agent ends its replicas when it drains: SIGTERM
        # first, so that none outlives the phase
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    summary = {"phase": "fleet", "gpu": card,
               "seconds": time.perf_counter() - t0,
               "tile_rows": [{k: r[k] for k in (
                   "tile", "shape", "dtype", "causal", "max_abs_err", "tol",
                   "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                   "bound_by", "tflops")} for r in tile_rows],
               "tune_launches": tune_launches,
               "tune_f32_launches": f32_row["launches"],
               "served_kernel_launches": served_launches,
               "winners": tune_row["winners"],
               "f32_winners": f32_row["winners"],
               "entries": tune_row["entries"]}
    emit(summary)
    return summary


def fl_replica_launches(urls):
    """Each replica's kernel launches (`/v1/stats` `kernel_launches`: what
    its served replays launched), for the replicas still up."""
    out = []
    for u in urls:
        try:
            out.append(get_json(u + "/v1/stats")["kernel_launches"])
        except Exception:  # noqa: BLE001 - scaled down meanwhile
            continue
    return out


def fl_alive(pid) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def fleet_flash_launches(summary) -> int:
    """The flash forward's launches on the fleet's path: the two tunes in
    the child, and the replicas' served replays."""
    return (summary["tune_launches"]["flash_attn_fwd"]
            + summary["tune_f32_launches"]["flash_attn_fwd"]
            + sum(r.get("flash_attn_fwd", 0)
                  for r in summary["served_kernel_launches"]))


def fleet_tile_entries(summary):
    """One entry a tile variant for the kernels line: its launches on the
    fleet's path and its numbers at the main shape of its body (bf16: the
    train shape; f32: [8, 512, 16, 128] causal), with every case."""
    out = []
    for name in ("bf16:128x128", "bf16:128x64", "f32:64x32", "f32:64x64"):
        cases = [r for r in summary["tile_rows"] if r["tile"] == name]
        main_row = cases[0]
        launches = (summary["tune_launches"].get(name, 0)
                    + summary["tune_f32_launches"].get(name, 0)
                    + sum(r.get(name, 0)
                          for r in summary["served_kernel_launches"]))
        out.append({
            "name": f"flash_attn_fwd[{name}]", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:106",
            "launches": launches, "shape": main_row["shape"],
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "cases": cases})
    return out


# --------------------------------------------------------------- text_trees

#: the text-and-trees path (slice 24): an SST-sized synthetic treebank (the
#: sizes of Socher et al. 2013's train and test splits), the RNTN at that
#: paper's width, and what feeds it
TT = dict(train=8544, held_out=2210, min_tokens=5, max_tokens=56,
          p_sentiment=0.4, p_negation=0.01, dim=25, classes=5, max_nodes=128,
          lr=0.05, l2=1e-4, epochs=30, eager_steps=2, rae_epochs=10,
          cpu_trees=512, cpu_epochs=1, cpu_rel_tol=1e-5, cpu_param_tol=1e-4,
          tag_sentences=256,
          w2v_sentences=512, w2v_vector=32, window=5, mlp_batch=256,
          mlp_steps=6)
#: the 5-way buckets of a span's lexicon score: <= -1, < -0.25, <= 0.25,
#: < 1, the rest
TT_CUTS = (-1.0, -0.25, 0.25, 1.0)


def tt_bucket(score: float) -> int:
    a, b, c, d = TT_CUTS
    return (0 if score <= a else 1 if score < b else 2 if score <= c
            else 3 if score < d else 4)


def tt_sexpr(toks, lex, rng) -> str:
    """A random binary bracketing of toks as a PTB s-expression, every node
    labelled with the bucket of its span's lexicon score (negation
    flipping the span, as the lexicon scores a sentence)."""
    label = tt_bucket(lex.score_tokens(toks))
    if len(toks) == 1:
        return f"({label} {toks[0]})"
    k = int(rng.randint(1, len(toks)))
    return (f"({label} {tt_sexpr(toks[:k], lex, rng)} "
            f"{tt_sexpr(toks[k:], lex, rng)})")


def tt_treebank(n: int, seed: int = 0):
    """n SST-like trees from `seed`: 5 to 56 tokens (log-normal around 17,
    SST's mean sentence is about 19), each a negation word of the lexicon
    with p_negation, a scored lexicon word with p_sentiment, else a word of
    the bundled tagger or lexicon that scores 0."""
    from deeplearning4j_tpu_torch.text.hmm_pos import bundled_tagger
    from deeplearning4j_tpu_torch.text.sentiment_lexicon import (
        NEGATION_WORDS, SentimentLexicon)

    lex = SentimentLexicon()
    tagger_words = set(bundled_tagger(device="cpu").log_emit)
    scored = sorted(w for w in lex.scores if w.isalpha() and lex.score(w))
    plain = sorted(w for w in tagger_words | set(lex.scores)
                   if w.isalpha() and not lex.score(w))
    negation = sorted(NEGATION_WORDS)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(np.clip(round(rng.lognormal(np.log(17.0), 0.5)),
                             TT["min_tokens"], TT["max_tokens"]))
        toks = []
        for u in rng.random_sample(length):
            pool = (negation if u < TT["p_negation"] else scored
                    if u < TT["p_negation"] + TT["p_sentiment"] else plain)
            toks.append(pool[rng.randint(len(pool))])
        out.append(tt_sexpr(toks, lex, rng))
    return out


def tt_majorities(plans):
    """Shares of the most common label at the roots and at the internal
    nodes (what RNTNEval counts) of stacked plans."""
    label = plans["label"].cpu().numpy()
    valid = plans["valid"].cpu().numpy()
    leaf = plans["is_leaf"].cpu().numpy()
    roots = label[np.arange(len(label)), valid.sum(1) - 1]
    internal = label[valid & ~leaf]
    share = lambda a: float(np.bincount(a).max() / len(a))  # noqa: E731
    return share(roots), share(internal)


def tt_saved_bytes(b, n, d) -> dict:
    """The tree step's saved state reckoned from its shapes (f32): the node
    buffer TreeScan keeps for its backward, and what keeping each step's
    [B, d, 2d] tensor-term product would cost instead."""
    return {"node_buffer": b * n * d * 4, "per_step_products": b * d * 2 * d
            * 4 * n}


def tt_train(torch, kernels, model, plans, epochs, name):
    """`epochs` AdaGrad steps of a tree model through its step cache: the
    first (warm-up and capture, then the first replay) timed on the host,
    the middle ones each between CUDA events, the last under the profiler.
    Returns the row (per-epoch losses, read back at the end), with the
    scatter launches of the steps before the profiled one (`profiled`
    takes its own back)."""
    t = time.perf_counter()
    losses = [model._step(plans)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    ms = []
    for _ in range(epochs - 2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(model._step(plans))
        stop.record()
        ms.append((start, stop))
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["scatter_add_rows"]
    prof = profiled(torch, kernels, lambda: losses.append(model._step(plans)),
                    f"text_trees_{name}_profile", ours_key="scatter")
    losses = [float(v) for v in losses]
    stats = model.step_cache.stats.as_dict()
    ms = [a.elapsed_time(b) for a, b in ms]
    row = {"model": name, "first_step_s": first_s,
           "capture_s": stats["compile_seconds"],
           "step_ms_median": median(ms), "step_ms_min": min(ms),
           "graph_pool_bytes": model.step_cache.pool.reserved_bytes,
           "books": stats, "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "scatter_launches": launches,
           "kernel_count": prof["kernel_count"],
           "device_ms": prof["device_ms"],
           "idle_share": 1.0 - prof["device_ms"] / median(ms)}
    check(all(np.isfinite(losses)), f"{name}: a loss is not finite")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall: "
                                  f"{losses[0]} -> {losses[-1]}")
    return row


def tt_eager(torch, kernels, make, state, plans, steps):
    """`steps` eager steps of a fresh model (its step cache's capture
    off) from `state`
    (params, hist, vocabulary), each timed between CUDA events, its first
    loss, and one more step profiled (kernels launched a step, device
    time). Not the main path: the caller reads its launch counts first."""
    model = make()
    model.step_cache.capture = False
    model.vocab = state[2]
    model.params = {k: v.clone() for k, v in state[0].items()}
    model._hist = {k: v.clone() for k, v in state[1].items()}
    losses, ms = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(model._step(plans))
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    prof = profiled(torch, kernels, lambda: model._step(plans),
                    f"text_trees_{model.kind}_eager_profile",
                    ours_key="scatter")
    return {"step_ms": ms, "first_loss": float(losses[0]),
            "kernel_count": prof["kernel_count"],
            "device_ms": prof["device_ms"],
            "idle_share_profiled": prof["idle_share"]}


def tt_scatter_row(torch, kernels, vocab_n, idx, d):
    """The scatter kernel at the RNTN's leaf-gradient shape ([vocab, d]
    table, an update for every plan step of every tree, most of them to
    row 0): checked against its plain version and timed as
    `phase_scatter_kernel` times its cases."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    exact, err, close, (ti, ui, table, upd, got, want) = scatter_check(
        torch, kernels, gen, vocab_n, d, idx, torch.float32)
    scratch = table.clone()
    bound_ms, bound_by, touched = scatter_bound_ms(torch, table, idx, upd)
    row = {"phase": "text_trees_scatter", "case": "rntn_leaf_grad",
           "rows": vocab_n, "width": d, "n": int(idx.shape[0]),
           "touched_rows": touched,
           "max_dup": int(torch.bincount(idx.long()).max().item()),
           "exact_on_integers": exact, "max_abs_err": err,
           "within_sum_bound": close, "ok": exact and close,
           "kernel_ms": graph_ms(lambda: kernels.scatter_add_rows_(
               scratch, idx, upd)),
           "plain_ms": graph_ms(lambda: kernels.scatter_add_rows_reference(
               table, idx, upd), iters=5, replays=1),
           "library_ms": graph_ms(lambda: scratch.index_add_(0, idx, upd)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    check(row["ok"], f"scatter_add_rows disagrees at the RNTN's shape: "
                     f"{row}")
    del ti, ui, table, upd, got, want, scratch
    return row


def tt_cpu_check(torch, train):
    """The card's RNTN after cpu_epochs against the CPU port's, from one
    draw (same seed, same trees): the loss within cpu_rel_tol, and every
    param within cpu_param_tol wherever the first gradient (the CPU's) is
    above 1e-3 of its largest. AdaGrad's 1e-8 start makes the first update
    lr * sign(g), so elements whose gradient is rounding noise move by lr
    either way and are left out; where |g| is under sqrt(1e-8) the start
    still dominates the history, and an update of about lr * g / 1e-4
    magnifies g's rounding. The scatter adds in any order on the card, so
    the two agree to rounding, not bitwise: the CPU's own rounding noise is
    shown beside the gaps, as the gaps of a CPU run over the same trees in
    another order (the same vocabulary and draws)."""
    from deeplearning4j_tpu_torch.models.rntn import RNTN, rntn_loss

    subset = train[:TT["cpu_trees"]]
    order = np.random.RandomState(1).permutation(len(subset))
    runs = {"cuda": ("cuda", subset), "cpu": ("cpu", subset),
            "cpu_reordered": ("cpu", [subset[i] for i in order])}
    out, params = {}, {}
    for name, (dev, trees) in runs.items():
        m = RNTN(dim=TT["dim"], n_classes=TT["classes"],
                 max_nodes=TT["max_nodes"], lr=TT["lr"], l2=TT["l2"],
                 seed=0, device=dev)
        m._prepare(subset)  # the vocabulary in the subset's order
        if name == "cpu":
            plans = m._plans(m._prepare(subset))
            ps = {k: v.detach().requires_grad_() for k, v in m.params.items()}
            g0 = dict(zip(ps, torch.autograd.grad(
                rntn_loss(ps, plans, TT["l2"]), list(ps.values()))))
        t = time.perf_counter()
        out[name] = m.fit(trees, epochs=TT["cpu_epochs"])
        out[f"{name}_s"] = time.perf_counter() - t
        params[name] = {k: v.detach().cpu() for k, v in m.params.items()}
    out["rel_gap"] = abs(out["cuda"] - out["cpu"]) / abs(out["cpu"])
    out["rel_gap_reordered"] = (abs(out["cpu_reordered"] - out["cpu"])
                                / abs(out["cpu"]))
    out["tol"] = TT["cpu_rel_tol"]
    out["param_tol"] = TT["cpu_param_tol"]
    out["params"] = {}
    for k, g in g0.items():
        live = g.abs() > 1e-3 * g.abs().max()
        gap = {n: float((params[n][k] - params["cpu"][k]).abs()[live].max())
               for n in ("cuda", "cpu_reordered")}
        out["params"][k] = {"live": int(live.sum()), "size": live.numel(),
                            "max_abs_grad": float(g.abs().max()),
                            "max_abs_gap": gap["cuda"],
                            "max_abs_gap_reordered": gap["cpu_reordered"]}
    check(out["rel_gap"] <= TT["cpu_rel_tol"]
          and all(v["max_abs_gap"] <= TT["cpu_param_tol"]
                  for v in out["params"].values()),
          f"the card's RNTN after {TT['cpu_epochs']} epochs is not the "
          f"CPU port's: {out}")
    return out


def tt_tagging(torch, sentences):
    """The chunk parser with the lexicon over `sentences`, its tagger's
    Viterbi on the card, against the same parser on the CPU: equal trees
    and tags. Returns the row."""
    from deeplearning4j_tpu_torch.text.sentiment_lexicon import (
        SentimentLexicon)
    from deeplearning4j_tpu_torch.text.tree_parser import TreeParser

    def sexpr(t):
        return (f"({t.label} {t.word})" if t.is_leaf else
                f"({t.label} {sexpr(t.left)} {sexpr(t.right)})")

    lex = SentimentLexicon()
    card = TreeParser("chunk", n_classes=3, lexicon=lex, device="cuda")
    cpu = TreeParser("chunk", n_classes=3, lexicon=lex, device="cpu")
    card.parse(sentences[0])  # loads the tagger, moves its tables
    torch.cuda.synchronize()
    t = time.perf_counter()
    trees = card.get_trees(sentences)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want = cpu.get_trees(sentences)
    cpu_s = time.perf_counter() - t
    tokens = [card.tokenizer_factory.create(s).get_tokens()
              for s in sentences]
    tags_equal = all(card.tagger.tag(tk) == cpu.tagger.tag(tk)
                     for tk in tokens)
    trees_equal = [sexpr(a) for a in trees] == [sexpr(b) for b in want]
    row = {"sentences": len(sentences),
           "tokens": sum(len(tk) for tk in tokens),
           "card_ms_per_sentence": card_s * 1e3 / len(sentences),
           "cpu_ms_per_sentence": cpu_s * 1e3 / len(sentences),
           "tags_equal": tags_equal, "trees_equal": trees_equal,
           "viterbi_device": str(card.tagger.device)}
    check(tags_equal and trees_equal,
          f"the card's tags or trees are not the CPU's: {row}")
    return row


def tt_windows(torch, kernels, sentences, labels):
    """A small port Word2Vec on the card, its windows through
    Word2VecDataSetIterator, and a few `fit` steps of the bench MLP on
    them: the score of the first batch must fall. Returns the row and the
    Word2Vec fit's scatter launches."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.models.word2vec_iterator import (
        Word2VecDataSetIterator)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.text.sentence_iterator import (
        LabelAwareSentenceIterator)

    before = kernels.LAUNCHES["scatter_add_rows"]
    t = time.perf_counter()
    w2v = Word2Vec(vector_length=TT["w2v_vector"], window=TT["window"],
                   min_word_frequency=1, negative=4, epochs=1,
                   batch_size=4096, seed=1, device="cuda").fit(sentences)
    w2v_s = time.perf_counter() - t
    w2v_launches = kernels.LAUNCHES["scatter_add_rows"] - before
    names = ["neg", "neutral", "pos"]
    it = Word2VecDataSetIterator(
        w2v, LabelAwareSentenceIterator(sentences, labels), names,
        batch=TT["mlp_batch"], window=TT["window"])
    net = MultiLayerNetwork(zoo.mlp(it.input_columns(), [512, 512], 3),
                            device="cuda").init()
    batches = []
    t = time.perf_counter()
    for ds in it:
        batches.append(ds)
        if len(batches) == TT["mlp_steps"]:
            break
    featurize_s = time.perf_counter() - t
    x0, y0 = batches[0].features, batches[0].labels
    s0 = net.score(x0, y0)
    scores = []
    for ds in batches:
        net.fit(ds.features, ds.labels)
        scores.append(net.score(x0, y0))
    row = {"w2v_fit_s": w2v_s, "w2v_words": w2v.cache.num_words(),
           "w2v_scatter_launches": w2v_launches,
           "input_columns": it.input_columns(),
           "featurize_ms_per_batch": featurize_s * 1e3 / len(batches),
           "batches": len(batches), "score_before": s0, "scores": scores}
    check(len(batches) == TT["mlp_steps"] and scores[-1] < s0,
          f"the window classifier's score did not fall: {row}")
    return row, w2v_launches


def phase_text_trees(torch, kernels):
    """The text-and-trees path at full width (TT): an SST-sized synthetic
    treebank from seed 0; the RNTN (dim 25, 5 classes, max_nodes 128,
    AdaGrad lr 0.05, l2 1e-4) for 30 full-batch epochs of captured steps,
    an eager model's steps from the same state, the held-out root and
    all-node accuracy and RNTNEval beside the majority shares, and the card
    against the CPU port after 3 epochs of a 512-tree subset; the RAE for
    10 epochs on the same trees; the scatter kernel at the leaf gradient's
    shape; the chunk parser's tags (Viterbi on the card) on 256 sentences
    against the CPU's; a window classifier over Word2VecDataSetIterator.
    Launch counts are zeroed just before each model's training and read
    just after. Returns the summary (emitted too)."""
    from deeplearning4j_tpu_torch.models.recursive_autoencoder import (
        RecursiveAutoEncoder, rae_loss)
    from deeplearning4j_tpu_torch.models.rntn import (RNTN, parse_tree,
                                                      tree_tokens)
    from deeplearning4j_tpu_torch.models.rntn_eval import RNTNEval

    card = gpu_line()
    t0 = time.perf_counter()
    t = time.perf_counter()
    bank = tt_treebank(TT["train"] + TT["held_out"])
    train, held_out = bank[:TT["train"]], bank[TT["train"]:]
    gen_s = time.perf_counter() - t

    def make_rntn():
        return RNTN(dim=TT["dim"], n_classes=TT["classes"],
                    max_nodes=TT["max_nodes"], lr=TT["lr"], l2=TT["l2"],
                    seed=0, device="cuda")

    model = make_rntn()
    t = time.perf_counter()
    trees = model._prepare(train)
    plans = model._plans(trees)
    plan_s = time.perf_counter() - t
    b, n = plans["word_id"].shape
    state0 = ({k: v.clone() for k, v in model.params.items()},
              {k: v.clone() for k, v in model._hist.items()},
              dict(model.vocab))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rntn_row = tt_train(torch, kernels, model, plans, TT["epochs"], "rntn")
    rntn_launches = rntn_row["scatter_launches"]
    rntn_row["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(rntn_launches > 0, "the scatter kernel never ran in the RNTN's "
                             "steps")
    rntn_row["eager"] = tt_eager(torch, kernels, make_rntn, state0, plans,
                                 TT["eager_steps"])
    rntn_row["first_loss_gap"] = abs(rntn_row["eager"]["first_loss"]
                                     - rntn_row["loss_first"])
    check(rntn_row["first_loss_gap"] <= 1e-5 * abs(rntn_row["loss_first"]),
          f"the captured first step is not the eager one: {rntn_row}")
    rntn_row["saved_bytes_reckoned"] = tt_saved_bytes(b, n, TT["dim"])
    t = time.perf_counter()
    root_acc = model.accuracy(held_out, root_only=True)
    node_acc = model.accuracy(held_out, root_only=False)
    ev = RNTNEval()
    ev.eval(model, held_out)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    root_major, internal_major = tt_majorities(model._plans(held_out))
    rntn_row.update({
        "held_out_root_accuracy": root_acc, "root_majority": root_major,
        "held_out_node_accuracy": node_acc,
        "rntn_eval_accuracy": ev.accuracy(), "rntn_eval_f1": ev.f1(),
        "internal_majority": internal_major, "eval_s": eval_s})
    check(root_acc > root_major and ev.accuracy() > internal_major,
          f"the RNTN does not beat the majority class: {rntn_row}")
    rntn_row["scatter_at_leaf_grad"] = tt_scatter_row(
        torch, kernels, len(model.vocab), plans["word_id"].reshape(-1),
        TT["dim"])
    rntn_row["cpu_check"] = tt_cpu_check(torch, train)
    rntn_row.update({"phase": "text_trees_rntn", "gpu": card,
                     "trees": b, "max_nodes": n,
                     "nodes": int(plans["valid"].sum().item()),
                     "vocab": len(model.vocab), "treebank_s": gen_s,
                     "plan_s": plan_s})
    emit(rntn_row)
    del model, plans, state0
    gc.collect()
    torch.cuda.empty_cache()

    def make_rae():
        return RecursiveAutoEncoder(dim=TT["dim"], max_nodes=TT["max_nodes"],
                                    lr=TT["lr"], l2=TT["l2"], seed=0,
                                    device="cuda")

    rae = make_rae()
    trees = rae._prepare(train)
    plans = rae._plans(trees)
    state0 = ({k: v.clone() for k, v in rae.params.items()},
              {k: v.clone() for k, v in rae._hist.items()}, dict(rae.vocab))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rae_row = tt_train(torch, kernels, rae, plans, TT["rae_epochs"], "rae")
    rae_launches = rae_row["scatter_launches"]
    rae_row["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(rae_launches > 0, "the scatter kernel never ran in the RAE's steps")
    rae_row["eager"] = tt_eager(torch, kernels, make_rae, state0, plans,
                                TT["eager_steps"])
    rae_row["first_loss_gap"] = abs(rae_row["eager"]["first_loss"]
                                    - rae_row["loss_first"])
    check(rae_row["first_loss_gap"] <= 1e-5 * abs(rae_row["loss_first"]),
          f"the RAE's captured first step is not the eager one: {rae_row}")
    with torch.no_grad():
        rae_row["held_out_reconstruction"] = float(rae_loss(
            rae.params, rae._plans(held_out), l2=0.0))
    rae_row.update({"phase": "text_trees_rae", "gpu": card})
    emit(rae_row)
    del rae, plans, state0
    gc.collect()
    torch.cuda.empty_cache()

    sentences = [" ".join(tree_tokens(parse_tree(s)))
                 for s in held_out[:TT["tag_sentences"]]]
    tag_row = tt_tagging(torch, sentences)
    tag_row.update({"phase": "text_trees_tagging", "gpu": card})
    emit(tag_row)

    w2v_sents = [" ".join(tree_tokens(parse_tree(s)))
                 for s in train[:TT["w2v_sentences"]]]
    roots = [int(s[1]) for s in train[:TT["w2v_sentences"]]]
    labels = [["neg", "neg", "neutral", "pos", "pos"][r] for r in roots]
    kernels.reset_launches()
    win_row, w2v_launches = tt_windows(torch, kernels, w2v_sents, labels)
    win_row.update({"phase": "text_trees_windows", "gpu": card})
    emit(win_row)
    summary = {"phase": "text_trees", "gpu": card,
               "seconds": time.perf_counter() - t0,
               "scatter_launches": {"rntn": rntn_launches,
                                    "rae": rae_launches,
                                    "word2vec": w2v_launches},
               "scatter_at_leaf_grad": rntn_row["scatter_at_leaf_grad"],
               "rntn_step_ms": rntn_row["step_ms_median"],
               "rntn_eager_step_ms": median(rntn_row["eager"]["step_ms"]),
               "rae_step_ms": rae_row["step_ms_median"],
               "held_out_root_accuracy": rntn_row["held_out_root_accuracy"],
               "rntn_eval_accuracy": rntn_row["rntn_eval_accuracy"]}
    emit(summary)
    return summary


# ------------------------------------------------------ scaleout_clustering

#: the scaleout_clustering phase: the distributed Word2Vec at the bench's
#: widths (W2V: vocab 10,000, 1.2 M tokens, vector 128, window 5, negative
#: 5, batch 32,768) with AdaGrad over 4 BSP workers, epochs cut to 1 (SGD at
#: that batch blows up in both packages, ROADMAP queue C); the distributed
#: GloVe (vector 128, window 15, batch 4,096) on the same corpus, epochs cut
#: to 2, at lr 0.01 (at GloVe's 0.05 the 4 workers' summed AdaGrad deltas
#: overshoot and the second epoch's loss rises, ROADMAP queue C); k-means on
#: 1,000,000 x 128 Gaussian blobs from seed 0, k = 256; exact t-SNE on
#: 10,000 rows of the MNIST stand-in, 1,000 iterations; Barnes-Hut t-SNE on
#: 2,000 of them on the host, iterations cut to bh_iters with the
#: exaggeration and first momentum cut to bh_stop (from 250 of 1,000: ~5 s
#: an iteration); the parameter server with 3 ps_worker processes, 4
#: rounds of tests/test_multiprocess_distributed.py's MLP
SC = dict(w2v_workers=4, w2v_epochs=1, profile_share=0.1,
          glove_vector=128, glove_window=15,
          glove_batch=4096, glove_epochs=2, glove_workers=4, glove_lr=0.01,
          km_n=1_000_000, km_d=128, km_k=256, km_spread=2.0, km_subset=20_000,
          km_tol=1e-4, km_max_iters=100, km_rate=1e-3,
          tsne_n=10_000, tsne_iters=300, tsne_check_n=500,
          tsne_check_iters=10, tsne_check_tol=1e-4, tsne_check_p_tol=1e-5,
          bh_n=2000, bh_iters=100, bh_stop=50,
          ps_workers=3, ps_rounds=4, ps_slow=2.0, fleet_ranks=2)


def sc_scatter_row(torch, kernels, case, rows_n, width, idx):
    """The scatter kernel at one of a distributed job's gather shapes (a
    table of rows_n x width, width 0 for a 1-D bias; the job's indices):
    checked against its plain version and timed as `tt_scatter_row`."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    exact, err, close, (ti, ui, table, upd, got, want) = scatter_check(
        torch, kernels, gen, rows_n, width, idx, torch.float32)
    scratch = table.clone()
    bound_ms, bound_by, touched = scatter_bound_ms(torch, table, idx, upd)
    row = {"phase": "scaleout_scatter", "case": case, "rows": rows_n,
           "width": width or 1, "n": int(idx.shape[0]),
           "touched_rows": touched,
           "max_dup": int(torch.bincount(idx.long()).max().item()),
           "exact_on_integers": exact, "max_abs_err": err,
           "within_sum_bound": close, "ok": exact and close,
           "kernel_ms": graph_ms(lambda: kernels.scatter_add_rows_(
               scratch, idx, upd)),
           "plain_ms": graph_ms(lambda: kernels.scatter_add_rows_reference(
               table, idx, upd), iters=5, replays=1),
           "library_ms": graph_ms(lambda: scratch.index_add_(0, idx, upd)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    check(row["ok"], f"scatter_add_rows disagrees at the {case} shape: "
                     f"{row}")
    del ti, ui, table, upd, got, want, scratch
    return row


def sc_w2v_job_batch(torch, model, centers, contexts):
    """The first step of job 0 of epoch 0 of a distributed fit over these
    pairs, as `DistributedWord2Vec.fit` makes it: its centers, contexts,
    and negatives from the job's key."""
    from deeplearning4j_tpu_torch.nd import random as nd_random
    from deeplearning4j_tpu_torch.scaleout.word2vec_performer import \
        job_batches

    perm = np.random.RandomState(model.seed).permutation(len(centers))
    chunk = max(1, len(perm) // SC["w2v_workers"])
    c_all, t_all, b_job = job_batches(centers[perm[:chunk]],
                                      contexts[perm[:chunk]],
                                      model.batch_size)
    cb = torch.as_tensor(c_all[:b_job], device="cuda")
    tb = torch.as_tensor(t_all[:b_job], device="cuda")
    codes, points, mask, neg_table = model._vocab_arrays()
    key = nd_random.fold_in(nd_random.fold_in(nd_random.fold_in(
        nd_random.prng_key(model.seed, device="cuda"), 0), 0), 0)
    slots = nd_random.randint(key, (b_job, model.negative), 0,
                              neg_table.shape[0])
    return cb, tb, points[tb], neg_table[slots]


def sc_word2vec(torch, kernels, sents):
    """The distributed Word2Vec at the bench's widths (AdaGrad, 4 BSP
    workers, 1 epoch) beside the single-process port's fit of the same
    corpus and configuration; the scatter launches of the distributed fit
    (zeroed just before, read just after: 3 a step); the scatter kernel at
    a job's syn0, syn1 and syn1neg shapes; a profiled fit of a tenth of the
    corpus (host share); quality on the two-cluster corpus as embed_quality
    checks it. Returns (row, launches)."""
    import deeplearning4j_tpu_torch.scaleout.word2vec_performer as wp
    from deeplearning4j_tpu_torch.models.word2vec import SYN_KEYS
    from deeplearning4j_tpu_torch.scaleout import DistributedWord2Vec

    kw = dict(vector_length=W2V["vector"], window=W2V["window"],
              negative=W2V["negative"], min_word_frequency=1,
              epochs=SC["w2v_epochs"], seed=W2V["seed"],
              batch_size=W2V["batch"], use_adagrad=True, device="cuda")
    model = DistributedWord2Vec(n_workers=SC["w2v_workers"], **kw)
    counter, restore = count_calls(wp, "w2v_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        t = time.perf_counter()
        model.fit(sents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        restore()
    launches = kernels.LAUNCHES["scatter_add_rows"]
    steps = counter["calls"]
    row = {"phase": "scaleout_w2v", "config": {
        **W2V, "epochs": SC["w2v_epochs"], "workers": SC["w2v_workers"],
        "use_adagrad": True, "mode": "bsp"},
        "steps": steps, "jobs": model.tracker.count("jobs_done"),
        "fit_wall_s": wall,
        "words_per_s": W2V["tokens"] * SC["w2v_epochs"] / wall,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tables_finite": all(bool(torch.isfinite(getattr(model.table, k))
                                  .all()) for k in SYN_KEYS)}
    check(steps > 0 and launches == W2V_GATHERS * steps,
          f"distributed word2vec: {launches} scatter launches in {steps} "
          f"steps, want {W2V_GATHERS} a step")
    check(row["tables_finite"], "a distributed word2vec table is not finite")
    # the single-process port on the same corpus and configuration
    single = bench_word2vec(use_adagrad=True, epochs=SC["w2v_epochs"])
    t = time.perf_counter()
    single.fit(sents)
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t
    row["single_process"] = {
        "fit_wall_s": single_wall,
        "words_per_s": W2V["tokens"] * SC["w2v_epochs"] / single_wall}
    del single
    # the scatter kernel at a job's shapes
    ids = [np.asarray([model.cache.index_of(t) for t in s], np.int32)
           for s in sents]
    model._rng = np.random.RandomState(model.seed)
    centers, contexts = model._pairs(ids)
    cb, tb, pts, neg = sc_w2v_job_batch(torch, model, centers, contexts)
    vocab_n = model.cache.num_words()
    row["scatter"] = {
        "syn0": sc_scatter_row(torch, kernels, "w2v_job_syn0", vocab_n,
                               W2V["vector"], cb),
        "syn1": sc_scatter_row(torch, kernels, "w2v_job_syn1", vocab_n - 1,
                               W2V["vector"], pts.reshape(-1)),
        "syn1neg": sc_scatter_row(
            torch, kernels, "w2v_job_syn1neg", vocab_n, W2V["vector"],
            torch.cat([tb[:, None], neg], 1).reshape(-1))}
    del model, centers, contexts, cb, tb, pts, neg
    gc.collect()
    torch.cuda.empty_cache()
    # host share of the jobs: a profiled fit of a tenth of the corpus
    sub = sents[:int(len(sents) * SC["profile_share"])]
    prof = profiled(torch, kernels, lambda: DistributedWord2Vec(
        n_workers=SC["w2v_workers"], **kw).fit(sub),
        "scaleout_w2v_profile", ours_key="scatter")
    row["profile_tenth"] = {k: prof[k] for k in (
        "wall_ms", "device_ms", "idle_share", "port_kernels_ms",
        "kernel_count")}
    row["host_share"] = prof["idle_share"]
    # quality: embed_quality's corpus and Word2Vec settings, 4 workers
    q = DistributedWord2Vec(vector_length=24, window=4, min_word_frequency=1,
                            negative=4, epochs=4, batch_size=256, seed=1,
                            n_workers=SC["w2v_workers"], device="cuda")
    q.fit(cluster_corpus())
    same, cross = q.similarity("cat", "dog"), q.similarity("cat", "truck")
    near = [w for w, _ in q.words_nearest("cat", top=4)]
    row["quality"] = {"cat_dog": same, "cat_truck": cross,
                      "nearest_cat": near}
    emit(row)
    check(same > cross, f"distributed word2vec: cat~dog {same} <= "
                        f"cat~truck {cross}")
    check(any(w in ("dog", "pet", "fur", "paw") for w in near),
          f"distributed word2vec: nearest to cat {near}")
    return row, launches


def sc_glove(torch, kernels, sents):
    """The distributed GloVe on the bench corpus (vector 128, window 15, 4
    workers, lr 0.01), its epochs cut to 2: its
    scatter launches (4 a step), the epoch losses (must fall), and the
    kernel at a job's w and b shapes. Returns (row, launches)."""
    import deeplearning4j_tpu_torch.scaleout.glove_performer as gp
    from deeplearning4j_tpu_torch.scaleout import DistributedGlove

    g = DistributedGlove(vector_length=SC["glove_vector"],
                         window=SC["glove_window"], min_word_frequency=1,
                         epochs=SC["glove_epochs"], lr=SC["glove_lr"],
                         batch_size=SC["glove_batch"], seed=0,
                         n_workers=SC["glove_workers"], device="cuda")
    counts_s = []
    real_count = g._count_cooccurrences

    def timed_count(token_lists):
        t = time.perf_counter()
        out = real_count(token_lists)
        counts_s.append(time.perf_counter() - t)
        return out

    g._count_cooccurrences = timed_count
    counter, restore = count_calls(gp, "glove_step")
    kernels.reset_launches()
    try:
        t = time.perf_counter()
        g.fit(sents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        restore()
    launches = kernels.LAUNCHES["scatter_add_rows"]
    steps = counter["calls"]
    row = {"phase": "scaleout_glove", "config": {
        "vector": SC["glove_vector"], "window": SC["glove_window"],
        "batch": SC["glove_batch"], "epochs": SC["glove_epochs"],
        "lr": SC["glove_lr"],
        "workers": SC["glove_workers"],
        "tokens": sum(len(s) for s in sents)},
        "fit_wall_s": wall, "cooccurrence_s": counts_s[0],
        "steps": steps, "launches": launches,
        "epoch_losses": g.epoch_losses,
        "finite": bool(torch.isfinite(g.table.syn0).all())}
    check(steps > 0 and launches == GLOVE_GATHERS * steps,
          f"distributed glove: {launches} scatter launches in {steps} "
          f"steps, want {GLOVE_GATHERS} a step")
    check(row["finite"] and g.epoch_losses[-1] < g.epoch_losses[0],
          f"the distributed glove's loss did not fall: {g.epoch_losses}")
    ids = [[g.cache.index_of(t) for t in s] for s in sents[:2000]]
    wi = torch.as_tensor(np.concatenate([np.asarray(s, np.int64)
                                         for s in ids])[:SC["glove_batch"]],
                         device="cuda")
    n = g.cache.num_words()
    row["scatter"] = {
        "w": sc_scatter_row(torch, kernels, "glove_job_w", n,
                            SC["glove_vector"], wi),
        "b": sc_scatter_row(torch, kernels, "glove_job_b", n, 0, wi)}
    emit(row)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches


def sc_mlp_conf_json() -> str:
    """tests/test_multiprocess_distributed.py:33-39's MLP: 4-8-3, lr 0.5,
    20 plain SGD iterations a fit."""
    from deeplearning4j_tpu_torch.models.zoo import mlp

    conf = mlp(4, [8], 3, lr=0.5)
    confs = tuple(c.replace(num_iterations=20, use_adagrad=False,
                            momentum=0.0) for c in conf.confs)
    return conf.replace(confs=confs).to_json()


def sc_start_fleets(td):
    """Start the subprocess fleets of the phase, which run while the card
    works on the rest: the BSP and the async parameter-server fleets (3
    ps_worker processes each on the card, the async one with a straggler,
    against servers in this process) and the LocalLauncher's two gloo
    ranks. Returns the handles for `sc_join_fleets`."""
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.param_server import \
        ParameterServer
    from deeplearning4j_tpu_torch.scaleout.provision import (
        ClusterSpec, HostProvisioner, HostSpec, LocalLauncher)

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    conf_json = sc_mlp_conf_json()
    conf_path = os.path.join(td, "conf.json")
    with open(conf_path, "w") as f:
        f.write(conf_json)
    net0 = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                             device="cuda", seed=7).init()
    fleets = {"net0": net0, "t0": time.perf_counter()}
    for mode in ("bsp", "async"):
        ps = ParameterServer(net0.params_flat().cpu().numpy(),
                             SC["ps_workers"], iterations=SC["ps_rounds"],
                             mode=mode)
        port = ps.serve(0)
        procs = []
        for i in range(SC["ps_workers"]):
            argv = [sys.executable, "-m",
                    "deeplearning4j_tpu_torch.scaleout.ps_worker",
                    "--server", f"http://127.0.0.1:{port}",
                    "--worker-id", f"w{i}", "--conf", conf_path,
                    "--rounds", str(SC["ps_rounds"]), "--timeout", "300"]
            if mode == "async" and i == SC["ps_workers"] - 1:
                argv += ["--slow", str(SC["ps_slow"])]
            procs.append(subprocess.Popen(
                argv, env=env, cwd=here, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        fleets[mode] = (ps, procs)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    spec = ClusterSpec(hosts=[HostSpec("127.0.0.1", ssh_port=22 + r)
                              for r in range(SC["fleet_ranks"])],
                       coordinator_port=free)
    script = os.path.join(td, "rank.py")
    with open(script, "w") as f:
        f.write("import sys, torch, torch.distributed as dist\n"
                f"sys.path.insert(0, {here!r})\n"
                "from deeplearning4j_tpu_torch.scaleout.provision import "
                "initialize_distributed\n"
                "assert initialize_distributed(device='cpu') is True\n"
                "t = torch.tensor([dist.get_rank() + 1.0])\n"
                "dist.all_reduce(t)\n"
                "assert t.item() == sum(range(1, dist.get_world_size() + 1))\n"
                "print('rank', dist.get_rank(), 'sum', t.item())\n"
                "dist.destroy_process_group()\n")
    prov = HostProvisioner(spec, launcher=LocalLauncher(
        os.path.join(td, "fleet")))
    prov.launch_workers(f"{sys.executable} {script}")
    fleets["launcher"] = prov
    return fleets


def sc_join_fleets(torch, fleets):
    """Wait for the fleets of `sc_start_fleets` and check them: every BSP
    round published and the averaged model's score below the start's; the
    async server took every delta (12), the straggler exited last, and its
    model's score fell too; both gloo ranks exited 0. Returns the row."""
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher

    data = IrisDataFetcher().fetch(150).normalize_zero_mean_unit_variance()
    net0 = fleets["net0"]
    start = net0.params_flat().clone()
    s0 = net0.score(data.features, data.labels)
    row = {"phase": "scaleout_fleets", "score_start": s0}
    for mode in ("bsp", "async"):
        ps, procs = fleets[mode]
        order, live = [], dict(enumerate(procs))
        deadline = time.perf_counter() + 300
        while live and time.perf_counter() < deadline:
            for i in list(live):
                if live[i].poll() is not None:
                    order.append(f"w{i}")
                    del live[i]
            time.sleep(0.05)
        errs = []
        for p in procs:
            if p.poll() is None:
                p.kill()
            out, err = p.communicate(timeout=30)
            errs.append(err[-1500:] if p.returncode else "")
        ps.shutdown()
        net0.set_params_flat(ps.current)
        score = net0.score(data.features, data.labels)
        acc = float((net0.predict(data.features)
                     == data.labels.argmax(-1)).mean())
        net0.set_params_flat(start)
        row[mode] = {"rcs": [p.returncode for p in procs],
                     "round": ps.round, "completed": sorted(ps.completed),
                     "errors": ps.errors, "exit_order": order,
                     "score": score, "accuracy": acc,
                     "metrics": dict(ps.metrics)}
        check(all(p.returncode == 0 for p in procs),
              f"a {mode} ps_worker failed: {errs}")
        check(score < s0, f"the {mode} fleet's score did not fall: {s0} -> "
                          f"{score}")
    check(row["bsp"]["round"] == SC["ps_rounds"],
          f"BSP published {row['bsp']['round']} rounds")
    check(row["async"]["round"] == SC["ps_workers"] * SC["ps_rounds"]
          and row["async"]["exit_order"][-1] == f"w{SC['ps_workers'] - 1}",
          f"the async fleet was gated or lost updates: {row['async']}")
    rcs = fleets["launcher"].wait(timeout=120)
    row["launcher_rcs"] = rcs
    row["seconds"] = time.perf_counter() - fleets["t0"]
    check(rcs == [0] * SC["fleet_ranks"],
          f"a LocalLauncher gloo rank failed: {rcs}")
    emit(row)
    return row


def sc_blob_saver(torch, td, net):
    """A BlobModelSaver round trip of a network's params on the card:
    bitwise."""
    from deeplearning4j_tpu_torch.scaleout.provision import (BlobModelSaver,
                                                             LocalBlobStore)

    saver = BlobModelSaver(LocalBlobStore(os.path.join(td, "store")),
                           key="models/mlp")
    saver.save(net.params, conf=net.conf, step=3)
    back, _, meta = saver.load(like_params=net.params)
    same = all(torch.equal(a, b) for layer_a, layer_b in zip(net.params, back)
               for a, b in zip(layer_a.values(), layer_b.values()))
    check(same and meta["step"] == 3, "the blob round trip is not bitwise")
    return {"bitwise": same, "step": meta["step"]}


def sc_word_count(sents):
    """`distributed_word_count` over the corpus against a serial count."""
    from collections import Counter

    from deeplearning4j_tpu_torch.scaleout import distributed_word_count
    from deeplearning4j_tpu_torch.text.tokenization import \
        DefaultTokenizerFactory

    docs = [" ".join(s) for s in sents]
    t = time.perf_counter()
    got = distributed_word_count(docs, n_workers=4)
    wall = time.perf_counter() - t
    tok = DefaultTokenizerFactory()
    want = Counter(w for d in docs for w in tok.tokenize(d))
    same = dict(got.items()) == dict(want)
    check(same, "distributed_word_count differs from a serial count")
    return {"equal_serial": same, "words": len(want),
            "tokens": sum(want.values()), "seconds": wall}


def sc_blobs(torch):
    """SC's k-means data on the card: km_k centers N(0, spread^2) in km_d
    dims, km_n points each at a uniformly drawn center plus N(0, 1), from a
    generator seeded 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.randn(SC["km_k"], SC["km_d"], generator=gen,
                          device="cuda") * SC["km_spread"]
    pick = torch.randint(0, SC["km_k"], (SC["km_n"],), generator=gen,
                         device="cuda")
    return centers[pick] + torch.randn(SC["km_n"], SC["km_d"], generator=gen,
                                       device="cuda")


def sc_timed_seeding(module):
    """Wrap module.kmeanspp_seed to record its seconds; (times, restore)."""
    real = module.kmeanspp_seed
    times = []

    def wrapped(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        times.append(time.perf_counter() - t)
        return out

    module.kmeanspp_seed = wrapped
    return times, lambda: setattr(module, "kmeanspp_seed", real)


def sc_kmeans(torch):
    """k-means at 1,000,000 x 128, k = 256: the fast path (`fit`) and the
    strategy framework with the convergence condition: seeding seconds, ms
    an iteration, iterations, peak device memory; then a 20,000-point
    subset through both on the card and in the CPU port, whose seeds,
    iterations and assignments must be equal."""
    import deeplearning4j_tpu_torch.clustering.kmeans as km
    import deeplearning4j_tpu_torch.clustering.strategy as st
    from deeplearning4j_tpu_torch.clustering import KMeansClustering

    x = sc_blobs(torch)
    row = {"phase": "scaleout_kmeans", "n": SC["km_n"], "d": SC["km_d"],
           "k": SC["km_k"], "x_gb": x.numel() * 4 / 1e9}
    for name, make, module in (
            ("fast", lambda dev: KMeansClustering(
                k=SC["km_k"], max_iterations=SC["km_max_iters"],
                tol=SC["km_tol"], seed=0, device=dev), km),
            ("strategy", lambda dev: KMeansClustering.setup(
                SC["km_k"], min_distribution_variation_rate=SC["km_rate"],
                seed=0, device=dev), st)):
        algo = make("cuda")
        times, restore = sc_timed_seeding(module)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t = time.perf_counter()
            centers, assign = algo.fit(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            restore()
        iters = (algo.iterations if name == "fast"
                 else algo.history.iteration_count)
        # the fast path runs one more update for the final assignment, the
        # framework one more iteration
        row[name] = {"seconds": wall, "seeding_s": times[0],
                     "iterations": iters,
                     "ms_per_iteration": (wall - times[0]) * 1e3
                     / (iters + 1),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "cluster_sizes_min_max": [
                         int(v) for v in torch.bincount(
                             assign, minlength=SC["km_k"]).aminmax()]}
        if name == "strategy":
            row[name]["last_location_change"] = \
                algo.history.most_recent.point_location_change
        check(bool(torch.isfinite(centers).all()) and iters >= 1,
              f"k-means {name}: {row[name]}")
        del centers, assign
        torch.cuda.empty_cache()
    sub = x[:SC["km_subset"]].clone()
    del x
    torch.cuda.empty_cache()
    subset = {}
    for name, make in (
            ("fast", lambda dev: KMeansClustering(
                k=SC["km_k"], max_iterations=SC["km_max_iters"],
                tol=SC["km_tol"], seed=0, device=dev)),
            ("strategy", lambda dev: KMeansClustering.setup(
                SC["km_k"], min_distribution_variation_rate=SC["km_rate"],
                seed=0, device=dev))):
        out = {}
        for dev, xs in (("cuda", sub), ("cpu", sub.cpu())):
            algo = make(dev)
            centers, assign = algo.fit(xs)
            out[dev] = (centers.cpu(), assign.cpu(),
                        algo.iterations if name == "fast"
                        else algo.history.iteration_count)
        subset[name] = {
            "iterations": [out["cuda"][2], out["cpu"][2]],
            "assign_equal": bool(torch.equal(out["cuda"][1], out["cpu"][1])),
            "centers_max_abs_gap": float(
                (out["cuda"][0] - out["cpu"][0]).abs().max())}
        check(subset[name]["assign_equal"]
              and out["cuda"][2] == out["cpu"][2],
              f"k-means {name} on the card differs from the CPU port on the "
              f"subset: {subset[name]}")
    row["subset_vs_cpu"] = subset
    emit(row)
    return row


def sc_tsne(torch):
    """Exact t-SNE on 10,000 rows of the MNIST stand-in for 1,000
    iterations on the card: P's seconds, ms an iteration (wall; and one
    gradient + update as CUDA-event device time), the KL history (must
    fall), peak memory; then on a 500-row subset the card's P within 1e-5
    of max P of the CPU port's and 10 iterations at learning rate 10 from
    one start
    within tsne_check_tol of max|y| (at the default rate of 500 the
    iteration is chaotic: tests/test_torch_tsne.py)."""
    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot import tsne as tsne_mod

    x, _ = conv_data("mnist", SC["tsne_n"])
    t = Tsne(max_iter=SC["tsne_iters"], seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    p = t.compute_p(x)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - s
    y = t.initial_y(SC["tsne_n"])
    inc, gains = torch.zeros_like(y), torch.ones_like(y)

    def one():
        g, _ = tsne_mod.tsne_grad(y, p)
        return tsne_mod.tsne_update(y, g, inc, gains, 0.5, 500.0, 0.01)

    iter_ms = cuda_ms(one, iters=5, warmup=1)
    del p, y, inc, gains
    s = time.perf_counter()
    emb = t.calculate(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - s
    row = {"phase": "scaleout_tsne", "n": SC["tsne_n"], "d": x.shape[1],
           "iterations": SC["tsne_iters"], "p_s": p_s,
           "calculate_s": wall,
           "ms_per_iteration": (wall - p_s) * 1e3 / SC["tsne_iters"],
           "iteration_device_ms": iter_ms, "kl_history": t.kl_history,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "finite": bool(np.isfinite(emb).all())}
    check(row["finite"] and t.kl_history[-1] < t.kl_history[0],
          f"t-SNE's KL did not fall: {t.kl_history}")
    torch.cuda.empty_cache()
    xs = x[:SC["tsne_check_n"]]
    kw = dict(max_iter=SC["tsne_check_iters"], learning_rate=10.0,
              exaggeration=4.0, seed=0)
    card, cpu = Tsne(device="cuda", **kw), Tsne(device="cpu", **kw)
    p_cpu = cpu.compute_p(xs)
    p_gap = float((card.compute_p(xs).cpu() - p_cpu).abs().max())
    y0 = cpu.initial_y(SC["tsne_check_n"])
    card.initial_y = lambda n: y0.to("cuda")
    cpu.initial_y = lambda n: y0
    ya, yb = card.calculate(xs), cpu.calculate(xs)
    y_gap = float(np.abs(ya - yb).max())
    row["subset_vs_cpu"] = {"n": SC["tsne_check_n"], "p_max_abs_gap": p_gap,
                            "p_max": float(p_cpu.max()),
                            "y_max_abs_gap": y_gap,
                            "y_max_abs": float(np.abs(yb).max())}
    emit(row)
    check(p_gap <= SC["tsne_check_p_tol"] * row["subset_vs_cpu"]["p_max"],
          f"the card's P differs from the CPU's: {row['subset_vs_cpu']}")
    check(y_gap <= SC["tsne_check_tol"] * row["subset_vs_cpu"]["y_max_abs"],
          f"the card's t-SNE iterations differ from the CPU's: "
          f"{row['subset_vs_cpu']}")
    return row


def sc_bh_child() -> int:
    """`chip_smoke.py --sc-bh-child`: Barnes-Hut t-SNE on SC["bh_n"] rows
    of the MNIST stand-in on the host, SC["bh_iters"] iterations with the
    exaggeration and the first momentum until SC["bh_stop"]; prints one
    JSON line with P's seconds, the iterations', the exact KL of the sparse
    P against the dense Q of the start and of the result, and the KL before
    and after a small step (the largest move 1e-3 of max|y|) along the
    Barnes-Hut gradient of the plain P at the result."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne

    n, iters = SC["bh_n"], SC["bh_iters"]
    x, _ = conv_data("mnist", n)
    bh = BarnesHutTsne(max_iter=iters, stop_lying_iter=SC["bh_stop"],
                       switch_momentum_iter=SC["bh_stop"], seed=0)
    t = time.perf_counter()
    sparse = bh.compute_gaussian_perplexity(x)
    p_s = time.perf_counter() - t
    bh.compute_gaussian_perplexity = lambda _x: sparse
    t = time.perf_counter()
    y = bh.calculate(x)
    it_s = time.perf_counter() - t
    # calculate's start: the same draw
    y0 = np.random.RandomState(0).randn(len(x), 2) * 1e-4

    def kl(emb):
        rows, cols, vals = sparse
        d2 = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
        num = 1.0 / (1.0 + d2)
        np.fill_diagonal(num, 0.0)
        q = num / num.sum()
        r = np.repeat(np.arange(len(emb)), np.diff(rows))
        return float(np.sum(vals * np.log(np.maximum(vals, 1e-12)
                                          / np.maximum(q[r, cols], 1e-12))))

    grad = bh.gradient(y, *sparse)
    step = y - grad * (1e-3 * np.abs(y).max() / np.abs(grad).max())
    emit({"phase": "scaleout_bh_tsne", "n": n, "iterations": iters,
          "stop_lying_iter": SC["bh_stop"], "p_s": p_s,
          "s_per_iteration": it_s / iters,
          "kl": [kl(y0), kl(y)], "kl_gradient_step": [kl(y), kl(step)],
          "finite": bool(np.isfinite(y).all())})
    return 0


def sc_bh_start():
    """Start the Barnes-Hut child on one host thread."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sc-bh-child"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    stop_at_exit(proc)
    return proc


def sc_bh_finish(proc) -> dict:
    """Wait for the Barnes-Hut child; emit its line and check that the
    exact KL at the end lies below the start's and that a step along the
    tree's gradient lowers it."""
    out, err = proc.communicate(timeout=900)
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    check(proc.returncode == 0 and len(rows) == 1,
          f"the Barnes-Hut child failed (rc {proc.returncode}): "
          f"{err[-3000:]}")
    row = rows[0]
    emit(row)
    check(row["finite"] and row["kl"][1] < row["kl"][0],
          f"Barnes-Hut t-SNE's KL did not fall: {row}")
    kl_a, kl_b = row["kl_gradient_step"]
    check(kl_b < kl_a,
          f"Barnes-Hut t-SNE's KL did not fall along its gradient: {row}")
    return row


def phase_scaleout_clustering(torch, kernels, bh=True):
    """The scaleout layer, clustering and t-SNE on the card at the sizes
    of SC; the fleets (after the GloVe) run meanwhile in their own
    processes, and so does the Barnes-Hut child, from the phase's start
    (`bh`; a full run starts it at its own start and passes False). Launch
    counts are zeroed just before each distributed fit and read just
    after. Returns the summary (emitted too)."""
    import tempfile

    card = gpu_line()
    t0 = time.perf_counter()
    bh_proc = sc_bh_start() if bh else None
    with tempfile.TemporaryDirectory() as td:
        sents = bench_sentences()
        w2v_row, w2v_launches = sc_word2vec(torch, kernels, sents)
        glove_row, glove_launches = sc_glove(torch, kernels, sents)
        # the fleets' eight processes start after the host-bound Word2Vec
        # steps and GloVe count, which would share the cores with them
        fleets = sc_start_fleets(td)
        wc = sc_word_count(sents)
        del sents
        km_row = sc_kmeans(torch)
        gc.collect()
        torch.cuda.empty_cache()
        tsne_row = sc_tsne(torch)
        blob = sc_blob_saver(torch, td, fleets["net0"])
        fleet_row = sc_join_fleets(torch, fleets)
    scatter = {**{f"w2v_job_{k}": v for k, v in w2v_row["scatter"].items()},
               **{f"glove_job_{k}": v
                  for k, v in glove_row["scatter"].items()}}
    summary = {"phase": "scaleout_clustering", "gpu": card,
               "seconds": time.perf_counter() - t0,
               "scatter_launches": {"distributed_word2vec": w2v_launches,
                                    "distributed_glove": glove_launches},
               "scatter_at_job_shapes": {
                   k: {f: r[f] for f in (
                       "n", "width", "rows", "max_abs_err", "kernel_ms",
                       "plain_ms", "bound_ms", "bound_by", "library_ms")}
                   for k, r in scatter.items()},
               "w2v_words_per_s": w2v_row["words_per_s"],
               "w2v_single_process_words_per_s":
                   w2v_row["single_process"]["words_per_s"],
               "w2v_host_share": w2v_row["host_share"],
               "glove_epoch_losses": glove_row["epoch_losses"],
               "word_count": wc, "blob_saver": blob,
               "kmeans_ms_per_iteration": {
                   k: km_row[k]["ms_per_iteration"]
                   for k in ("fast", "strategy")},
               "kmeans_iterations": {k: km_row[k]["iterations"]
                                     for k in ("fast", "strategy")},
               "kmeans_peak_mem_gb": max(km_row[k]["peak_mem_gb"]
                                         for k in ("fast", "strategy")),
               "tsne_ms_per_iteration": tsne_row["ms_per_iteration"],
               "tsne_kl": [tsne_row["kl_history"][0],
                           tsne_row["kl_history"][-1]],
               "fleets_s": fleet_row["seconds"]}
    if bh_proc is not None:
        summary.update(sc_bh_summary(sc_bh_finish(bh_proc)))
    emit(summary)
    return summary


#: the analysis_ui phase's sizes: the zoo audit's rows and scores scale,
#: the t-SNE route's rows, its checked and its timed iterations, the
#: perplexity, and the traced char-LSTM's batch
AN = dict(rows=4, seq_threshold=256, tsne_n=2000, tsne_dims=50,
          tsne_check_iters=20, tsne_iters=300, perplexity=30.0,
          trace_rows=32)


def an_tsne_route(device, vecs, iters):
    """POST /api/tsne on a fresh `UiServer(device=...)` over `vecs`:
    (the answer, the coordinates, the route's ms)."""
    from deeplearning4j_tpu_torch.ui import UiServer

    server = UiServer(device=device).start()
    try:
        post(server.url + "/api/vectors",
             {"vectors": vecs.tolist(), "labels": []})
        t0 = time.perf_counter()
        out = post(server.url + "/api/tsne",
                   {"iters": iters, "perplexity": AN["perplexity"]})
        ms = (time.perf_counter() - t0) * 1e3
        coords = np.asarray(get_json(server.url + "/api/coords")["coords"])
    finally:
        server.stop()
    return out, coords, ms


def an_tsne(torch) -> dict:
    """The UI server's t-SNE on the card against the same route on the
    CPU. The iteration is chaotic (tests/test_torch_ui_plot.py), so the
    coordinates after AN's checked iterations are held to ten times the
    CPU run's own gap when its input moves by one float32 ulp."""
    rng = np.random.RandomState(0)
    centers = rng.randn(10, AN["tsne_dims"]) * 4.0
    vecs = (centers[rng.randint(0, 10, AN["tsne_n"])]
            + rng.randn(AN["tsne_n"], AN["tsne_dims"])).astype(np.float32)
    it = AN["tsne_check_iters"]
    card, card_xy, card_ms = an_tsne_route("cuda", vecs, it)
    cpu, cpu_xy, cpu_ms = an_tsne_route("cpu", vecs, it)
    _, moved_xy, _ = an_tsne_route(
        "cpu", np.nextafter(vecs, np.float32(np.inf), dtype=np.float32), it)
    gap = float(np.abs(card_xy - cpu_xy).max())
    own = float(np.abs(moved_xy - cpu_xy).max())
    kl_rel = abs(card["kl"] - cpu["kl"]) / max(abs(cpu["kl"]), 1e-12)
    check(card["n"] == cpu["n"] == AN["tsne_n"], "t-SNE route row count")
    check(kl_rel <= 1e-4, f"t-SNE KL on the card {card['kl']} vs the CPU "
          f"{cpu['kl']}")
    check(gap <= 10 * own, f"t-SNE coordinates on the card {gap} "
          f"from the CPU's, its own gap {own}")
    full, full_xy, full_ms = an_tsne_route("cuda", vecs, AN["tsne_iters"])
    check(np.isfinite(full_xy).all() and full["n"] == AN["tsne_n"],
          "t-SNE route at its default iterations")
    return {"rows": AN["tsne_n"], "check_iters": it,
            "card_ms": card_ms, "cpu_ms": cpu_ms, "max_abs_gap": gap,
            "cpu_own_gap": own, "kl_rel_gap": kl_rel,
            "iters": AN["tsne_iters"], "ms": full_ms, "kl": full["kl"]}


def an_trace(torch, kernels) -> dict:
    """One full-width char-LSTM `output` under `Tracer` on the card: the
    Chrome trace must name the f32 cell kernel."""
    import tempfile

    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.quantize import \
        default_calibration
    from deeplearning4j_tpu_torch.utils.profiling import Tracer

    conf = zoo.precision_eval_confs(False)["char_lstm"]
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    x = default_calibration(conf, AN["trace_rows"])
    with tempfile.TemporaryDirectory() as td:
        tracer = Tracer(td)
        before = kernels.launch_snapshot()["lstm_cell"]
        with tracer.trace(), Tracer.annotate("char_lstm_output"):
            out = net.output(x)
        launches = kernels.launch_snapshot()["lstm_cell"] - before
        with open(tracer.trace_path) as fh:
            names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
    check(bool(torch.isfinite(out).all()), "char-LSTM output not finite")
    cell = [n for n in names if "lstm_cell_f32_kernel" in n]
    check(bool(cell), "the trace names no lstm_cell_f32_kernel")
    check("char_lstm_output" in names, "the trace names no annotate span")
    return {"events": len(names), "lstm_cell_f32_kernel_events": len(cell),
            "launches": launches}


def an_plot(torch) -> dict:
    """The plotter's histograms of a char-LSTM's params, where matplotlib
    is installed."""
    import importlib.util
    import tempfile

    if importlib.util.find_spec("matplotlib") is None:
        return {"skipped": "matplotlib is not installed on this machine"}
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.plot.plotter import NeuralNetPlotter

    net = MultiLayerNetwork(zoo.char_lstm(64, hidden=256, n_layers=1),
                            device="cuda", seed=0).init()
    with tempfile.TemporaryDirectory() as td:
        path = NeuralNetPlotter(td).plot_weight_histograms(net.params)
        size = os.path.getsize(path)
    check(size > 0, "empty weight histogram")
    return {"png_bytes": size}


def phase_analysis_ui(torch, kernels) -> dict:
    """The analysis layer, the UI server's t-SNE, the tracer and the
    plotter on the card (AN). Launch counts of every kernel are read just
    before and just after. Returns the summary (emitted too)."""
    import contextlib as _contextlib
    import io

    from deeplearning4j_tpu_torch.analysis import audit_cache
    from deeplearning4j_tpu_torch.analysis.program_audit import (
        audit_attention_structure, audit_zoo_programs)
    from deeplearning4j_tpu_torch.cli import driver
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.quantize import \
        default_calibration

    card = gpu_line()
    t0 = time.perf_counter()
    start = kernels.launch_snapshot()
    # analyze runs the small zoo's programs and, once in the phase, the
    # decode and speculative-parity audits (its error gate holds them)
    out = io.StringIO()
    with _contextlib.redirect_stdout(out):
        rc = driver.main(["analyze", "--fail-on", "error",
                          "--format", "json"])
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and report["counts"]["error"] == 0,
          f"analyze on the card: rc {rc}, {report['counts']}: "
          f"{[f for f in report['findings'] if f['severity'] == 'error']}")
    analyze_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    zoo_findings, zoo_programs = audit_zoo_programs(
        small=False, rows=AN["rows"], seq_threshold=AN["seq_threshold"])
    errors = [f.as_dict() for f in zoo_findings if f.severity == "error"]
    check(not errors, f"zoo audit at published widths: {errors}")
    zoo_s = time.perf_counter() - t1

    conf = zoo.precision_eval_confs(False)["char_transformer"]
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    net.set_serve_precision("bf16", measure=False)
    net.output(default_calibration(conf, AN["rows"]))
    bf16 = audit_cache(net.infer_cache, seq_threshold=AN["seq_threshold"])
    check(not [f for f in bf16 if f.severity == "error"],
          f"bf16 charTransformer output audit: {bf16}")
    del net

    before = kernels.launch_snapshot()
    attention = audit_attention_structure(S=1024)
    after = kernels.launch_snapshot()
    attn_launches = {k: after[k] - before[k] for k in
                     ("flash_attn_fwd",) + BWD_KERNELS}
    check(attention == [], f"attention audit at S=1024: {attention}")
    check(all(n > 0 for n in attn_launches.values()),
          f"the attention audit did not launch rows 1-4: {attn_launches}")

    tsne = an_tsne(torch)
    trace = an_trace(torch, kernels)
    plot = an_plot(torch)
    end = kernels.launch_snapshot()
    # by kernel, and the flash forward's launches by body and tile too
    launches = {k: end[k] - start[k] for k in end}
    summary = {"phase": "analysis_ui", "gpu": card,
               "seconds": time.perf_counter() - t0,
               "analyze": {"seconds": analyze_s, "counts": report["counts"],
                           "checked": report["checked"]},
               "zoo_published": {"seconds": zoo_s, "programs": zoo_programs,
                                 "counts": {s: sum(f.severity == s
                                                   for f in zoo_findings)
                                            for s in ("info", "warn",
                                                      "error")}},
               "bf16_output_warns": [f.message for f in bf16
                                     if f.severity == "warn"],
               "attention_launches": attn_launches,
               "tsne": tsne, "trace": trace, "plot": plot,
               "launches": launches}
    emit(summary)
    return summary


def sc_bh_summary(row) -> dict:
    """The Barnes-Hut child's figures for the phase's summary."""
    return {"bh_kl": row["kl"], "bh_kl_gradient_step": row["kl_gradient_step"],
            "bh_seconds": row["p_s"] + row["s_per_iteration"]
            * row["iterations"]}


#: the full run's late phases, in turn, each in a process of its own as
#: `chip_smoke.py FLAG` runs it alone: (flag, the phase whose summary line
#: it returns, its time limit in seconds). A child has a fresh CUDA
#: context, NCCL communicator and profiler: in the process that has run and
#: profiled every earlier phase, the profiler misnamed kernels of a graph
#: replay (a full run's profiled trainer replay named 5 of each backward
#: kernel's 8 launches, where the host counts and the phase run alone gave
#: 8)
CHILDREN = (("--only-data-parallel", "data_parallel", 900),
            ("--only-tensor-parallel", "tensor_parallel", 900),
            ("--only-serve-mesh", "serve_mesh", 900),
            ("--only-serve-precision", "serve_precision", 900),
            ("--only-fleet", "fleet", 900),
            ("--only-text-trees", "text_trees", 600),
            ("--only-scaleout-clustering", "scaleout_clustering", 600),
            ("--only-analysis-ui", "analysis_ui", 300))


class Children:
    """Runs CHILDREN in turn. Each child starts while the one before it
    runs: it imports, loads the kernels and opens its CUDA context, then
    waits on its stdin (`--wait-turn`, `wait_turn`), so that its start-up
    overlaps the phase before it. `extra` maps a flag to more arguments.
    Output goes to files, so a waiting child never blocks on a pipe."""

    def __init__(self, extra=None):
        self.queue = list(CHILDREN)
        self.extra = extra or {}
        self.waiting = None

    def start(self) -> None:
        """Start the next child, to wait for its turn."""
        import tempfile

        if not self.queue or self.waiting is not None:
            return
        flag = self.queue[0][0]
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, "--wait-turn",
             *self.extra.get(flag, ())],
            stdin=subprocess.PIPE, stdout=out, stderr=err, text=True)
        stop_at_exit(proc)
        self.waiting = (proc, out, err)

    def run(self, phase: str) -> dict:
        """Let the next child run `phase` and start the one after it; echo
        the child's lines and return its summary."""
        self.start()
        flag, name, timeout = self.queue.pop(0)
        check(name == phase, f"child {flag} runs {name}, not {phase}")
        (proc, out, err), self.waiting = self.waiting, None
        t0 = time.perf_counter()
        proc.stdin.write("go\n")
        proc.stdin.flush()
        self.start()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.seek(0)
        err.seek(0)
        rows = []
        for line in out.read().strip().splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append(json.loads(line))
        summary = [r for r in rows if r.get("phase") == phase]
        check(proc.returncode == 0 and len(summary) == 1,
              f"the {phase} child failed (rc {proc.returncode}): "
              f"{err.read()[-3000:]}")
        emit({"phase": f"{phase}_child", "seconds": time.perf_counter() - t0})
        return summary[0]


def wait_turn(torch, argv) -> None:
    """Under `--wait-turn` (a child that `Children` starts ahead of its
    turn): open the CUDA context, then wait for the parent's word on stdin;
    exit if the parent goes away instead."""
    if "--wait-turn" not in argv:
        return
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    if sys.stdin.readline().strip() != "go":
        sys.exit(3)
    _T0[0] = time.perf_counter()


def stop_at_exit(proc) -> None:
    """Kill `proc` at this process's exit if it still runs (a failed check
    leaves no child behind)."""
    import atexit

    atexit.register(lambda: proc.poll() is None and proc.kill())


def f32_case(r, library_key):
    """One f32 row's numbers for the kernels line."""
    return {"shape": r["shape"], "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "fma_bound_ms": r["fma_bound_ms"],
            "library_ms": r[library_key] if library_key else None,
            "tflops": r["tflops"]}


def f32_entry(case_rows, name):
    """The f32 body's numbers for the kernels line, causal and not, at
    [8, 512, 16, 128]: from phase_kernels' rows (name None) or from
    phase_bwd_kernels' rows of kernel `name`. Its library yardstick is SDPA
    in f32 (forward; for dK/dV and dQ its whole backward), for delta
    `torch.linalg.vecdot(dO, O, dim=-1)`."""
    library_key = ("library_ms" if name is None else
                   "vecdot_ms" if name == "flash_bwd_delta"
                   else "sdpa_backward_ms")
    return {key[4:]: f32_case(case_rows[key] if name is None
                              else case_rows[key][name], library_key)
            for key in ("f32_causal", "f32_not_causal")}


def reference_errors(rows, outputs):
    """The max errors of `outputs` in each `f32_reference_check` row, and
    whether all of them meet the reference's tolerance."""
    return [{"shape": r["shape"], "causal": r["causal"],
             **{name: r[name]["max_abs_err"] for name in outputs},
             "ok": all(r[name]["ok"] for name in outputs)} for r in rows]


def main(argv) -> int:
    import torch

    quick = "--quick" in argv
    if "--sc-bh-child" in argv:
        # the scaleout_clustering phase's Barnes-Hut t-SNE (host only)
        return sc_bh_child()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        return 2
    if "--only-pretraining" in argv:
        # slice 18's phase alone (it launches none of the kernels): for
        # iterating on it; prints no kernels line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_pretraining(torch, kernels)
        return 0
    if "--dp-ckpt-child" in argv:
        # the data_parallel phase's SIGTERM child
        i = argv.index("--dp-ckpt-child")
        return dp_ckpt_child(argv[i + 1])
    if "--only-data-parallel" in argv:
        # slice 19's phase alone (for iterating on it, and as the full
        # run's child): prints no kernels line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build()
        wait_turn(torch, argv)
        phase_data_parallel(torch, kernels)
        return 0
    if "--only-tensor-parallel" in argv:
        # the tensor_parallel phase alone (the full run's child; under
        # torchrun, the four-card run): no kernels line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if os.environ.get("RANK") == "0":
                kernels.build()
            import torch.distributed as dist

            from deeplearning4j_tpu_torch.parallel.mesh import \
                init_distributed

            init_distributed()
            dist.barrier()
            kernels.build()
            return tp_ranks(torch, kernels)
        kernels.build()
        wait_turn(torch, argv)
        phase_tensor_parallel(torch, kernels)
        return 0
    if "--only-serve-mesh" in argv:
        # the serve_mesh phase alone (the full run's child; under
        # torchrun, the four-card run): no kernels line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if os.environ.get("RANK") == "0":
                kernels.build()
            import torch.distributed as dist

            from deeplearning4j_tpu_torch.parallel.mesh import \
                init_distributed

            init_distributed()
            dist.barrier()
            kernels.build()
            return sm_ranks(torch, kernels)
        kernels.build()
        wait_turn(torch, argv)
        phase_serve_mesh(torch, kernels)
        return 0
    if "--sp-child" in argv:
        # the serve_precision phase's second process on its store
        return sp_child_run(argv[argv.index("--sp-child") + 1])
    if "--only-serve-precision" in argv:
        # the serve_precision phase alone (the full run's child): no
        # kernels line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build()
        wait_turn(torch, argv)
        phase_serve_precision(torch, kernels)
        return 0
    if "--only-fleet" in argv:
        # the fleet phase alone (the full run's child): no kernels line and
        # no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build()
        wait_turn(torch, argv)
        phase_fleet(torch, kernels)
        return 0
    if "--only-text-trees" in argv:
        # the text_trees phase alone (the full run's child): no kernels
        # line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build(["scatter_add"])
        wait_turn(torch, argv)
        phase_text_trees(torch, kernels)
        return 0
    if "--only-scaleout-clustering" in argv:
        # the scaleout_clustering phase alone (the full run's child): no
        # kernels line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build(["scatter_add"])
        wait_turn(torch, argv)
        phase_scaleout_clustering(torch, kernels,
                                  bh="--sc-no-bh" not in argv)
        return 0
    if "--only-analysis-ui" in argv:
        # the analysis_ui phase alone (the full run's child): no kernels
        # line and no last line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build()
        wait_turn(torch, argv)
        phase_analysis_ui(torch, kernels)
        return 0
    if "--seed-sweeps" in argv:
        # the recipes that hang on the initial draw (SEED_SWEEPS)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.nd import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build()
        conv_vgg_seeds(torch, kernels)
        pre_ae_seeds(torch)
        return 0
    if "--conv-f32-child" in argv:
        # conv_f32's child: PyTorch's default flags, none of the below
        return conv_f32_child(argv[argv.index("--conv-f32-child") + 1])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.nd import kernels

    card = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "gpu": card, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    kernels.build()
    ptxas = [line.strip() for log in kernels.BUILD_LOGS.values()
             for line in log.splitlines() if "registers" in line]
    # warnings, and ptxas's notes that it serialised wgmma instructions
    notes = [line.strip() for log in kernels.BUILD_LOGS.values()
             for line in log.splitlines()
             if "warning" in line.lower() or "Performance Loss" in line]
    bodies = tma_ptxas(kernels)
    f32_bodies = f32_ptxas(kernels)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(kernels.SOURCES), "ptxas": ptxas,
          "ptxas_notes": notes, "tma_bodies": bodies,
          "f32_bodies": f32_bodies})
    if quick:
        # a new kernel's first call on the card: build, registers and
        # spills, one check at the path's widths, stop
        ok = phase_quick(torch, kernels)
        check_bodies(bodies, f32_bodies)
        # the generation path at 2 blocks: served, checked, timed once
        phase_generate(torch, kernels, quick=True)
        return 0 if ok else 1

    # the scaleout_clustering phase's Barnes-Hut t-SNE, on one host thread
    # beside every phase up to that one's end
    bh_proc = sc_bh_start()
    with phase_clock("kernels"):
        fwd_rows = phase_kernels(torch, kernels)
    fwd_row, fwd_train_row = fwd_rows["serve"], fwd_rows["train"]
    with phase_clock("bwd_kernels"):
        bwd_rows = phase_bwd_kernels(torch, kernels)
    with phase_clock("f32_reference"):
        reference_rows = phase_f32_reference(torch, kernels)
    with phase_clock("serve"):
        serve_launches, surface_launches = phase_serve(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("generate"):
        gen_launches, gen_kernel_rows, gen_option_launches = phase_generate(
            torch, kernels)
    check(gen_launches["flash_attn_fwd"] > 0,
          "the flash kernel never ran in generation")
    with phase_clock("train"):
        train_launches, f32_train_launches = phase_train(torch, kernels)
    gc.collect()
    check(serve_launches["flash_attn_fwd"] > 0, "the flash kernel never ran")
    check(surface_launches > 0, "the flash kernel never ran under f1_score "
          "and evaluate(evaluation=)")
    for name in ("flash_attn_fwd",) + BWD_KERNELS:
        check(train_launches[name] > 0, f"{name} never ran in training")
    torch.cuda.empty_cache()
    with phase_clock("lstm_kernel"):
        lstm_rows, lstm_layer = phase_lstm_kernel(torch, kernels)
    lstm_row = lstm_rows["bench"]
    with phase_clock("lstm_train"):
        lstm_train_launches = phase_lstm_train(torch, kernels)
    with phase_clock("checkpoint"):
        ckpt_launches = phase_checkpoint(torch, kernels)
    with phase_clock("lstm_cli"):
        lstm_cli_launches = phase_lstm_cli(torch, kernels)
    check(lstm_train_launches > 0 and lstm_cli_launches > 0
          and ckpt_launches > 0, "the LSTM cell kernel never ran")
    torch.cuda.empty_cache()
    with phase_clock("scatter_kernel"):
        sents = bench_sentences()
        fixed = w2v_fixed_batch(torch, sents)
        _, centers, contexts, neg, vocab = fixed
        scatter_rows = phase_scatter_kernel(
            torch, kernels, centers, contexts, neg, vocab[1])
    with phase_clock("w2v_train"):
        w2v_launches, w2v_row = phase_w2v_train(torch, kernels, sents, fixed)
    del fixed, centers, contexts, neg, vocab
    with phase_clock("embed_quality"):
        quality_launches = phase_embed_quality(torch, kernels)
    check(w2v_launches > 0 and all(quality_launches.values()),
          "the scatter-add kernel never ran")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("datasets_serve_api"):
        api_serve_launches, api_train_launches = phase_datasets_serve_api(
            torch, kernels)
    for name in ("flash_attn_fwd",) + BWD_KERNELS:
        check(api_train_launches[name] > 0,
              f"{name} never ran in the datasets_serve_api phase's steps")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("conv_nets"):
        phase_conv_nets(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    # the late phases' children: each starts while the phase before it runs
    children = Children({"--only-scaleout-clustering": ["--sc-no-bh"]})
    children.start()
    with phase_clock("pretraining"):
        phase_pretraining(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("data_parallel"):
        dp_launches = children.run("data_parallel")["launches"]
    for name in ("flash_attn_fwd",) + BWD_KERNELS + ("lstm_cell",):
        check(dp_launches[name] > 0,
              f"{name} never ran in the data-parallel trainer's steps")
    with phase_clock("tensor_parallel"):
        tp_summary = children.run("tensor_parallel")
    tp_launches = tp_summary["launches"]
    for name in ("flash_attn_fwd",) + BWD_KERNELS:
        check(tp_launches[name] > 0,
              f"{name} never ran in the tensor-parallel trainer's steps")
    with phase_clock("serve_mesh"):
        sm_summary = children.run("serve_mesh")
    sm_launches = sum(sm_summary["launches"].values())
    check(sm_launches > 0, "flash_attn_fwd never ran in the serve_mesh "
          "phase's mesh runs")
    with phase_clock("serve_precision"):
        sp_summary = children.run("serve_precision")
    sp_launches = sp_summary["flash_launches"]
    check(sp_launches > 0 and sp_summary["lstm_launches"] > 0,
          "the serve_precision phase launched no flash or cell kernel")
    with phase_clock("fleet"):
        fl_summary = children.run("fleet")
    fl_launches = fleet_flash_launches(fl_summary)
    check(fl_launches > 0, "flash_attn_fwd never ran in the fleet phase")
    with phase_clock("text_trees"):
        tt_summary = children.run("text_trees")
    tt_launches = tt_summary["scatter_launches"]
    check(tt_launches["rntn"] > 0 and tt_launches["rae"] > 0,
          "the scatter kernel never ran in the text_trees phase's steps")
    with phase_clock("scaleout_clustering"):
        sc_summary = children.run("scaleout_clustering")
        sc_summary.update(sc_bh_summary(sc_bh_finish(bh_proc)))
    sc_launches = sc_summary["scatter_launches"]
    check(all(n > 0 for n in sc_launches.values()),
          "the scatter kernel never ran in the distributed Word2Vec or "
          "GloVe steps")
    with phase_clock("analysis_ui"):
        an_launches = children.run("analysis_ui")["launches"]
    for name in ("flash_attn_fwd",) + BWD_KERNELS + ("lstm_cell",):
        check(an_launches[name] > 0,
              f"{name} never ran in the analysis_ui phase")
    emit({"phase": "phase_seconds", "gpu": card,
          "total_s": time.perf_counter() - _T0[0],
          "phases_s": PHASE_SECONDS})

    bwd_src = "deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu"
    replaces = {"flash_bwd_delta": 229, "flash_bwd_dkv": 241,
                "flash_bwd_dq": 311}
    rows = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:106",
        "launches": (serve_launches["flash_attn_fwd"]
                     + gen_launches["flash_attn_fwd"]
                     + sum(gen_option_launches.values())
                     + train_launches["flash_attn_fwd"]
                     + sum(api_serve_launches.values())
                     + api_train_launches["flash_attn_fwd"]
                     + dp_launches["flash_attn_fwd"]
                     + tp_launches["flash_attn_fwd"] + sm_launches
                     + sp_launches + fl_launches
                     + an_launches["flash_attn_fwd"] + surface_launches),
        "launches_by_path": {"serve": serve_launches["flash_attn_fwd"],
                             "generate": gen_launches["flash_attn_fwd"],
                             **gen_option_launches,
                             "train": train_launches["flash_attn_fwd"],
                             "api_serve_batched":
                                 api_serve_launches["batched"],
                             "api_serve_unbatched":
                                 api_serve_launches["unbatched"],
                             "api_checkpoint_listener":
                                 api_train_launches["flash_attn_fwd"],
                             "data_parallel": dp_launches["flash_attn_fwd"],
                             "tensor_parallel":
                                 tp_launches["flash_attn_fwd"],
                             "serve_mesh": sm_launches,
                             "serve_precision": sp_launches,
                             "fleet": fl_launches,
                             "analysis_ui": an_launches["flash_attn_fwd"],
                             "serve_f1_evaluate": surface_launches},
        # the f32 conf's forward under each serve policy: 8 launches, the
        # 3xTF32 body under f32 and the TMA bf16 body under bf16 and int8
        "serve_precision": {
            "by_policy": sp_summary["flash_by_policy"],
            "generate": sp_summary["generate_flash_launches"]},
        # the analysis_ui phase's forward launches by body and tile: the
        # small zoo's f32 charTransformer and the S = 1024 audit on the
        # f32 body, the bf16-policy audit on the TMA body
        "analysis_ui_by_tile": {k: an_launches[k]
                                for k in kernels.TILE_LAUNCHES},
        "max_abs_err": fwd_row["max_abs_err"],
        "ms": fwd_row["kernel_ms"], "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"], "bound_by": fwd_row["bound_by"],
        "library_ms": fwd_row["library_ms"],
        "design": "tma+wgmma", "ptxas": bodies["flash_attn_fwd"],
        "tflops": fwd_row["tflops"],
        # the numbers above are at the serving shape; the train step's
        # forward (B=32, with lse) gets its own
        "at_train_shape": {
            "max_abs_err": fwd_train_row["max_abs_err"],
            "max_abs_err_lse": fwd_train_row["max_abs_err_lse"],
            "ms": fwd_train_row["kernel_ms"],
            "plain_ms": fwd_train_row["plain_ms"],
            "bound_ms": fwd_train_row["bound_ms"],
            "bound_by": fwd_train_row["bound_by"],
            "library_ms": fwd_train_row["library_ms"],
            "tflops": fwd_train_row["tflops"]},
        # the plan step's forward at its per-rank heads (model = 2, 4)
        "at_tensor_parallel_shapes": {
            m: rows["flash_attn_fwd"]
            for m, rows in tp_summary["kernels"].items()},
        # the served mesh's prefill at each rank's heads (H / M, M = 2,
        # 4) and the served output's shape
        "at_serve_mesh_shapes": sm_summary["kernels"],
        # each tile variant of the two bodies: its launches on the
        # fleet's path (the tunes' attention groups, the tuned flagship's
        # served replays) and its numbers at the fleet phase's shapes
        "tile_variants": fleet_tile_entries(fl_summary),
        # every prefill's forward (B = 1, S = a warmed prompt bucket,
        # causal, no lse); SDPA is the library column
        "at_prefill_shapes": [{k: r[k] for k in (
            "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tflops")} for r in gen_kernel_rows],
        "f32": dict(
            f32_entry(fwd_rows, None), design="3xtf32 mma.sync + cp.async",
            ptxas=f32_bodies["flash_attn_fwd"],
            # causal with lse on qkv views, and the CLI char_transformer's
            # forward (D = 32, no lse)
            causal_view=f32_case(fwd_rows["f32_causal_view"], "library_ms"),
            cli=f32_case(fwd_rows["f32_cli"], "library_ms"),
            reference_shapes=reference_errors(reference_rows, ("o", "lse")))}]
    for name in BWD_KERNELS:
        r = bwd_rows[name]
        rows.append({
            "name": name, "route": "cuda", "source": bwd_src,
            "replaces": ("deeplearning4j_tpu/nd/pallas_kernels.py:"
                         f"{replaces[name]}"),
            "launches": (train_launches[name] + api_train_launches[name]
                         + dp_launches[name] + tp_launches[name]
                         + an_launches[name]),
            "launches_by_path": {
                "train": train_launches[name],
                "api_checkpoint_listener": api_train_launches[name],
                "data_parallel": dp_launches[name],
                "tensor_parallel": tp_launches[name],
                "analysis_ui": an_launches[name]},
            # at the plan step's per-rank heads (model = 2, 4)
            "at_tensor_parallel_shapes": {
                m: rows[name] for m, rows in tp_summary["kernels"].items()},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # delta: `torch.linalg.vecdot(dO, O, dim=-1)` on the bf16 views,
            # whose result is bf16 (rounded) where delta is f32; SDPA's
            # backward computes what delta, dK/dV and dQ compute together
            "library_ms": (r["vecdot_ms"] if name == "flash_bwd_delta"
                           else r["sdpa_backward_ms"]),
            "library_covers": ("vecdot, bf16 result"
                               if name == "flash_bwd_delta"
                               else "delta + dkv + dq"),
            "max_rel_err": r["max_rel_err"], "tflops": r["tflops"]})
        rows[-1]["f32"] = f32_entry(bwd_rows, name)
        # launched by the train phase's f32 fused gradient check
        rows[-1]["f32"]["launches"] = f32_train_launches[name]
        rows[-1]["f32"]["reference_shapes"] = reference_errors(
            reference_rows, {"flash_bwd_delta": ("delta",),
                             "flash_bwd_dkv": ("dk", "dv"),
                             "flash_bwd_dq": ("dq",)}[name])
        if name in f32_bodies:
            rows[-1]["f32"].update(
                design="3xtf32 mma.sync + cp.async",
                ptxas=f32_bodies[name],
                # causal on qkv views, and causal at ragged S with D = 100
                causal_view=f32_case(bwd_rows["f32_causal_view"][name],
                                     "sdpa_backward_ms"),
                ragged=f32_case(bwd_rows["f32_ragged"][name],
                                "sdpa_backward_ms"))
        if name == "flash_bwd_dq":
            # delta + dK/dV + dQ beside SDPA's whole f32 backward
            rows[-1]["f32"]["backward"] = {
                key[4:]: {k: f32_backward_sum(bwd_rows[key])[k]
                          for k in ("sum_ms", "sdpa_backward_ms")}
                for key in ("f32_causal", "f32_not_causal")}
        if name in bodies:
            rows[-1].update({"design": "tma+wgmma", "ptxas": bodies[name]})
    rows.append({
        "name": "lstm_cell", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:529",
        "launches": (lstm_train_launches + ckpt_launches + lstm_cli_launches
                     + dp_launches["lstm_cell"]
                     + sp_summary["lstm_launches"]
                     + an_launches["lstm_cell"]),
        "launches_by_path": {"lstm_train": lstm_train_launches,
                             "checkpoint": ckpt_launches,
                             "lstm_cli": lstm_cli_launches,
                             "data_parallel": dp_launches["lstm_cell"],
                             "serve_precision":
                                 sp_summary["lstm_launches"],
                             "analysis_ui": an_launches["lstm_cell"]},
        # the f32-compute char-LSTM under the bf16 and int8 serve policies:
        # lstm_cell_bf16_kernel, T launches a layer a forward
        "serve_precision": sp_summary["lstm_by_policy"],
        "max_abs_err": lstm_row["max_abs_err"], "ms": lstm_row["kernel_ms"],
        "plain_ms": lstm_row["plain_ms"], "bound_ms": lstm_row["bound_ms"],
        "bound_by": lstm_row["bound_by"],
        # torch.lstm_cell: the same cell, in PyTorch's gate order
        "library_ms": lstm_row["library_ms"],
        # the bf16 body at the bench shape, the CLI's and a tiny ragged one
        "bf16": {name: {k: lstm_rows[name][k] for k in (
            "shape_bih", "max_abs_err", "kernel_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for name in ("bench_bf16", "cli_bf16", "ragged_bf16")},
        # one [256, 64, 256] f32 layer: 64 launches, and cuDNN's nn.LSTM
        "layer_fused_ms": lstm_layer["fused_ms"],
        "layer_cudnn_lstm_call_ms": lstm_layer["cudnn_lstm_call_ms"]})
    syn1 = scatter_rows["syn1"]
    rows.append({
        "name": "scatter_add_rows", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/scatter_add.cu",
        "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:600",
        "launches": (w2v_launches + sum(quality_launches.values())
                     + sum(tt_launches.values())
                     + sum(sc_launches.values())
                     + an_launches["scatter_add_rows"]),
        "launches_by_path": {"w2v_train": w2v_launches,
                             "embed_quality": quality_launches,
                             "text_trees": tt_launches,
                             "scaleout": sc_launches,
                             "analysis_ui": an_launches["scatter_add_rows"]},
        "launches_per_w2v_step": W2V_GATHERS,
        # the numbers below are at the syn1 shape of the bench's step
        "max_abs_err": syn1["max_abs_err"], "ms": syn1["kernel_ms"],
        "plain_ms": syn1["plain_ms"], "bound_ms": syn1["bound_ms"],
        "bound_by": syn1["bound_by"],
        # Tensor.index_add_: the same function in one PyTorch call
        "library_ms": syn1["library_ms"],
        "cases": {name: {k: r[k] for k in ("n", "width", "dtype",
                                           "max_abs_err", "kernel_ms",
                                           "plain_ms", "bound_ms",
                                           "library_ms")}
                  for name, r in scatter_rows.items()},
        # the RNTN's leaf gradient: E [vocab, 25], a row a plan step
        "at_rntn_leaf_grad": {k: tt_summary["scatter_at_leaf_grad"][k]
                              for k in ("n", "width", "rows", "max_abs_err",
                                        "kernel_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        # a distributed job's gathers: the Word2Vec's syn0, syn1 and
        # syn1neg at a job's first step, the GloVe's w and b
        "at_distributed_job_shapes": sc_summary["scatter_at_job_shapes"],
        "w2v_step_ms_median": w2v_row["step_ms_median"],
        "w2v_words_per_s": w2v_row["words_per_s"]})
    emit({"kernels": rows})
    check_bodies(bodies, f32_bodies)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
