#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), the time to
   build the CUDA kernels from ``flexflow_tpu_torch/ops/kernels/csrc``,
   and the built flash library's SASS (cuobjdump), which must hold
   tensor-core HMMA instructions in every instance of the forward, dQ
   and dK/dV tensor-core kernels (fp32, bf16, fp16) and HGMMA in every
   instance of their bf16 and fp16 wgmma bodies, and the CUDA-core dQ
   only for head dims above 128; and the paged library's, which must hold HMMA in
   every instance of the paged kernel's tensor-core body (3 cache forms
   x single-pass and split x 3 head-dim pads) and none in its CUDA-core
   body.
2. kernels: each paged attention kernel against its plain PyTorch
   version on the card, in each form (an fp32, a bf16 and an fp16 cache
   under fp32 queries: both sides widen K and V exactly and compute in
   fp32), atol 1e-4 + rtol 1e-4 (the kernel sums in another order), at
   the serving path's shapes (with the cluster size
   each launched), at a suffix prefill's windows (W = 16, 32, 33, 64,
   256, 512 and 1024 from positions 0 and 512, then padding queries;
   40- and 41-query verify windows over 4 slots; the split form at
   W = 64: from W = 9 at D <= 128 the tensor-core body) and at edge shapes, among them contexts that leave
   blocks of a cluster without a live position, split counts up to the
   table's width, windows of padding only and a 60000-column table
   through both kernels; the split-KV path must run as one device
   kernel; then the device time
   (CUDA events around a replayed CUDA graph of the calls) of the
   kernel, the plain version and one PyTorch library call over the same
   inputs (scaled_dot_product_attention on the gathered K/V, a yardstick
   the port never calls; for a 2-byte cache in that dtype with q cast to
   it, a lower-precision function timed for speed only), beside the
   card's bound (K and V at their element size) for the body the window
   runs: fp32 operations on the CUDA cores, or three TF32 products (two
   over a 2-byte cache) on the tensor cores; both are printed.
3. serving: a GPT-2-small-width decoder (12 x 768, 12 heads, vocab
   50257, 1024 positions, random weights from --seed, fp32) behind a
   4-slot engine and the continuous-batching scheduler (its default: the
   overlap pipeline on); 8 requests of
   16-700 prompt tokens and 32 new tokens each (6 greedy, 2 seeded
   temperature 0.8 / top-k 50), through an engine whose steps replay
   captured CUDA graphs (the default) and one built with
   eager_steps=True, in the order graph, eager, eager, graph, each
   engine warmed first with a prompt in every prefill bucket (so every
   graph is captured before the timed runs). The streams of both must be
   identical, the launch counters must show one paged kernel launch per
   layer per decode step, and one decode step's logits must agree with
   the plain attention path within 1e-3.
4. kv dtype: the serving cell over a bf16 KV cache of 257 blocks (half
   the fp32 cell's bytes), graph and eager engines from zeroed caches:
   identical streams, bit-identical caches and last logits, one bf16
   kernel launch per layer per decode step and no fp32 one; greedy
   streams equal to plain attention over the same cache dtype (tokens
   equal to the fp32 cache's run printed, not gated); a decode step's
   logits vs plain attention within 1e-3; a decode step's device time,
   fp32 and bf16 engines in turns; greedy and k = 4 speculative streams
   equal, with decode and verify logits vs plain; the long-context
   request (split-KV, S = 8); the host tier (three 512-token prefixes
   cycled twice through 80 blocks: swaps out and in, streams equal to the
   uncached engine's). Then fp16: 4 requests with speculation (decode
   and verify steps) and a long context, with the logits gates.
5. long context: the same model in a 1-slot engine with a ~900-token
   prompt, where the split-KV (flash-decoding) kernel is selected (one
   launch per layer per decode step, combined on-chip); graph and eager
   engines as in 3.
6. step graphs: prefill (four buckets), decode and verify steps replayed
   from their graphs against the same steps run eagerly, at GPT-2-small
   width: tokens, logits and the KV cache bit-identical, one capture per
   signature, num_layers paged launches counted per replay; and the
   device time of the threefry Gumbel draws a decode step ([4, V]) and a
   verify step (2 x [4, 5, V]) make.
7. speculation: 4 slots, k = 4, the n-gram drafter, 4 prompts of
   repeated segments, 48 new greedy tokens each: plain, then speculative
   through the graph engine and through the eager engine. The greedy
   streams must equal the plain ones, decode and verify logits must agree
   with the plain attention path within 1e-3, and the paged launches must
   be num_layers x (decode + verify steps). Reports the verify step ms,
   the acceptance rate and the tokens per verify step.
8. prefix cache: the same model behind 4 slots with the cross-request
   prefix cache on and off, on graph and on eager steps: 8 requests
   sharing a 512-token system prompt (suffixes of 20-480 tokens, and one
   exact repeat, whose boundary block is copied), and a 64-token shared
   prefix with a 700-token suffix (suffix bucket 1024), 32 new tokens
   each (6 greedy + 2 seeded among the 8). Streams must be identical
   on/off and graph/eager, the hit, reuse and copy counters > 0, each
   suffix prefill num_layers paged launches, one capture per suffix
   bucket. Reports TTFT p50 and the prefill step's time per request
   (CUDA events) on and off, and the suffix prefill's by suffix bucket. Then the host tier: three 512-token
   prefixes cycled twice through an 80-block cache, streams equal to the
   uncached engine's, swaps out and in > 0 (and the pinned
   host-to-device rate beside the swap model's).
   The earlier serving phases run with the cache off: they repeat their
   prompts across runs.
9. overlap + recovery: the 4-slot serving cell (the serving phase's
   request lengths and samplings) through the graph engine with the
   overlap pipeline on and off (on, off, off, on, after a warm-up):
   streams identical across the four runs and to the eager engine's
   sequential run, the pipeline engaged (dispatches > 0, drains by
   reason, no discards), one capture per signature, 12 paged launches per
   decode step, and a carried step's logits within 1e-3 of the plain
   attention path; tokens/s and TTFT p50 on and off; the steady stretch
   (4 slots x 128 steps, nothing non-steady; 32 steps on eager steps):
   ms per step, the stream's time per step (CUDA events around each
   launch), and the device's busy share: a decode step's device time
   (its graph replayed back to back right after the window) over the ms
   per step, with the SM clock and power read just after, on and off. Then recovery on the card: a
   decode-step crash and an async-readback error (each an engine reset
   and journal replay: ``donate`` is set on a CUDA engine) and a NaN on
   one slot (quarantine): surviving streams equal the fault-free ones,
   the expected resets, the cache tensors unmoved, nothing captured
   again.
10. constrained decoding: a 50257-entry token table (the port's default
   table, which stops at 1422 entries, then three-character fillers), a
   JSON-schema grammar ({"ok": boolean, "n": integer}) and a regex grammar
   ([a-z]{1,8}-[0-9]{2,4}) compiled against it (seconds printed); the
   serving cell's 8 request lengths as prefixes of one random sequence,
   4 constrained (2 greedy, 2 at temperature 0.8 / top-k 50) and 4
   unconstrained, 32 new tokens each, through the graph engine (overlap
   on, off, and again on), the eager engine, the graph engine with greedy
   n-gram speculation (k = 4) and a graph engine with the prefix cache on
   (the constrained admissions become masked suffix prefills). Every
   constrained text must parse as its grammar says, the streams must be
   identical across all runs (under speculation the greedy ones), each
   step num_layers paged launches, and no run may capture anything (each
   engine first served the same requests unconstrained). A masked decode
   step and a masked verify step (legal drafts) must agree with the plain
   attention path plus the same grammar rows within 1e-3. Then the decode
   step's ms with four unconstrained slots (overlap off and on) and with
   one constrained slot (an endless [a-z ]+ grammar), the mask bytes
   written per step, and a mask_advance error that must quarantine one
   constrained request while the rest equal the fault-free run.
11. server: the port's InferenceServer on 127.0.0.1 with a
   GenerationModel over a 4-slot graph engine (prefix cache on): the
   serving cell's 8 requests (4 SSE, 4 JSON) from client threads at once,
   cold and warm, then a JSON-schema, a speculation and a best-effort
   request; streams equal to the same requests straight to a scheduler,
   no new capture, num_layers paged launches per step, /metrics valid.
12. durable: durable serving and request journeys across a SIGKILL. A
   child process (this script with ``--durable-child WAL_DIR``) serves
   the serving cell's engine (4 slots, 257 fp32 blocks, graph steps,
   overlap on) through a GenerationModel with durability (fsync on) and
   journeys on; the parent posts the cell's 4 JSON requests, then, once
   they are admitted, its 4 SSE ones with a client traceparent, tails the
   WAL and polls /v2/durable, and SIGKILLs the child once every stream
   holds >= 8 journaled tokens and one is unfinished. A fresh engine in
   this process then warm-restarts from the same WAL and serves over
   HTTP: all 8 streams must equal the serving phase's fault-free ones,
   /v2/generate/resume/{id} must give each restarted stream whole from
   event 0 and only its tail after the client's Last-Event-ID, each
   traceparent request's /v2/debug/journey/{id} must carry the client's
   trace id, spans from both sides of the kill and a warm_restart hop,
   and be complete; one fingerprint on both sides, num_layers paged
   launches per decode step on the restarted engine, one capture per
   signature; torn records are counted and printed. Then the steady
   4-slot stretch (128 steps, overlap on) with durability off, on with
   fsync and on without, in turns over two rounds (ms per step,
   flush_step host ms p50 / p99, fsyncs per second, WAL bytes per token,
   the garbage collector's pauses), and with journeys on and off.
13. fleet: the fleet tier on one card (``serving/fleet.py``), GPT-2-small
   width, fp32, 4-slot graph engines of 257 blocks from one factory that
   warms every prefill bucket, every replica stepping on its own loop
   thread: the single engine (a started GenerationModel) for the
   baseline; ``Fleet(factory, 2)`` over the serving cell (streams equal
   to the serving phase's, 12 paged launches per decode step); the
   prefix cell through ``Fleet(factory, 2)`` with the prefix cache on
   (router affinity decisions > 0, prefix hits only on replicas holding
   the system prompt, streams equal to the prefix phase's); failover:
   ``replica_kill(plan, "r0", every=1)`` once each replica holds >= 2
   residents (streams equal to the fault-free run, >= 1 failover, one
   replacement spawned and captured while the survivor serves, nothing
   captured on the survivor); ``DisaggregatedFleet`` (1 prefill + 1
   decode replica) over the serving cell (streams equal, 8 imports and 0
   rejected, no prefill step on the decode replica, 12 paged launches
   per decode-pool step, the payload bytes of 125 blocks), then with a
   NaN on one handoff block (caught by its CRC, replayed on the decode
   pool, streams equal); the serving fleet behind ``InferenceServer``
   (4 SSE + 4 JSON streams equal, /v2/fleet, /v2/fleet/autoscale and
   /metrics with the fleet families). Tokens/s, TTFT p50 and the steady
   decode ms per step of each beside the single engine's, the handoff's
   pack and import ms and bytes, the replacement's spawn-and-capture s.
13b. tools: the port's serving tools (``flexflow_tpu_torch/tools``)
   through their own functions at GPT-2-small width: genbench's base
   mode twice (one capture per prefill bucket and one decode, none in
   steady state, no self-healing, streams = ``engine.generate``'s, 12
   paged launches per decode step; prefill and decode tokens/s); loadgen
   ``--url`` against an InferenceServer over that engine (max_queue 16;
   12 arrivals/s for 4 s, then 80/s for 2 s; answers only 200/503/504,
   none failed, nothing shed in the first leg, every 200's tokens =
   ``engine.generate``'s, loadgen's token total = /metrics', no capture;
   per class submitted, shed, expired and latency p50/p99); obsreport's
   summary, cache, slo, anatomy and predict views, ``predict --export``
   of the card's ledger (device tag ``h100``) calibrating
   ``SimCosts.from_ledger_export`` from its measured p50s and refused as
   ``cpu``, two identical ``simfleet sweep``s over it; ``simfleet
   simcheck`` with its live storm on the card; chaoscheck's recovery
   sweep on the card; perfwatch over the two base runs' history.
14. anatomy: torch.profiler over a short 4-slot run — the device's busy
   share of the wall time and the device time by kernel; eight decode
   steps of four live slots under the profiler, replayed and eager
   (device and wall ms a step, device kernels a step, one paged kernel a
   layer); then, in the long-context engine, a second stream's replayed
   decode steps under the profiler (device ms and device kernels per
   step, one paged kernel per layer) and ten split-KV attention calls,
   whose device kernels must all be the paged kernel; then the prefix
   cell's W = 1024 suffix prefill (a 700-token suffix after a cached
   64-token prefix) through graph engines over fp32, bf16 and fp16
   caches, whose paged kernels must all be the tensor-core body of the
   cache's form, by name, with its device ms and launches by window. The
   profiler runs only after the timed phases: once started, it slows the
   host's later launches.
15. flash kernels: the flash-attention forward, dQ and dK/dV kernels,
   float32, bf16 and fp16 forms, against their plain PyTorch versions
   (fp32: atol 1e-4 + rtol 1e-4; bf16 and fp16: within one ulp of the
   type at the plain value plus 1e-3, the logsumexp at the fp32 gate) at
   the training path's shape (B=32, S=128, H=12, D=64) and at a causal
   S=512 shape and edge shapes (S=100 D=128, Sq=64 Sk=200, D=256, S=1,
   S=65 plain and causal, D=8, D=300 and D=512; bf16 at D=33, Sq != Sk,
   D=256 and D=512; fp16 at a sample of those), fp16 where its range
   matters (most of P below 2^-14, |dS| past 65504, dS of order 1e-6;
   gated at one ulp + 1e-3 of each output's largest |value|),
   and multihead attention's core with v's head dim other than q's (the
   kernels on zero-padded head dims, all forms, forward and gradients);
   then device times of kernel, plain version and the library yardstick
   (scaled_dot_product_attention forward, and its backward: its kernels'
   durations by torch.profiler) in the same dtype, beside the card's
   bound (fp32: fp32-accurate products on the tensor cores, and the same
   operations on the fp32 CUDA cores; bf16 and fp16: 2-byte tensors,
   the dense bf16 / fp16 rate).
16. training: BERT-Base width (12 layers, hidden 768, 12 heads, ff 3072,
   seq 128, batch 32, weights from --seed) through FFModel -> compile
   (SGD lr 0.01, MSE) -> fit, first in fp32, then bf16 (``bench.py``'s
   cell: bf16 parameters and activations), then fp16 (DataType.HALF: no
   master weights and no loss scaling, as in the JAX package): one step
   with the kernels and
   one with the plain attention from the same weights must agree (fp32:
   loss rtol 1e-5, parameters within 1e-3 of the step's largest update;
   bf16 and fp16: loss rtol 2^-8 and 2^-11, each parameter within 2 ulps
   of the type plus 1/8 of its tensor's update), and every parameter
   must keep its type; then warm-up and 10 timed steps on one random
   batch, where each flash launch counter of the cell's form must rise
   by 12 per step, all on the wgmma bodies for bf16 and fp16, and the
   other forms' stay 0, and the loss must fall; and a profiled pair of
   steps for the device's busy share and the device time by kernel group
   (the flash kernels, cuBLAS GEMMs, elementwise and other).
17. heads: the BERT that users train, with its token embedding, a head
   and dropout 0.1, through FFModel -> compile (SGD lr 0.01, sparse
   categorical cross-entropy, accuracy) -> fit: bert-cls
   (bert-base-uncased: 12 layers, hidden 768, 12 heads, ff 3072, vocab
   30522; seq 128, batch 32, SST-2's 2-class CLS head) in fp32, then in
   bf16; bert-mlm (the same encoder with the LM head, a softmax over
   30522, fp32); seq2seq (Transformer-base: 6 + 6 layers, d_model 512, 8
   heads, ff 2048, an LM head over 37000; source 128, target 96, batch
   32, fp32; the cross-attention's flash kernels take 96 queries over 128
   keys). Each: one step with the kernels and one with plain attention
   from the same weights and step key must draw the same dropout masks
   (bit for bit, keeping ~0.9 of the elements) and agree at the training
   phase's gates; then warm-up and 10 timed steps (5 for bert-mlm and
   seq2seq), where each flash counter of the cell's form rises by the
   attention layers a step (by attention kind for seq2seq), all on the
   wgmma bodies for bf16, and the loss on the batch without dropout must
   fall; the dropout masks' device ms a step (CUDA events around each
   draw) and a profiled pair's device ms by kernel group, the masks'
   int64 threefry kernels a group of their own.
18. infer: bert-cls's fp32 model after its fit, saved by ``save_model``
   to a temporary repository, loaded by an ``InferenceServer`` through
   ``POST /v2/repository/models/bert_sst2/load`` (max batch 32); 16
   client threads post 64 requests of 1-4 rows as KServe v2 JSON to
   ``/v2/models/bert_sst2/infer``: each response within 1e-5 of
   ``predict`` on the same rows with the same argmax, more than one
   request a device batch on average, 12 ``ff_flash_fwd_f32`` launches
   a device batch and no other, ``/metrics``' completed requests equal
   to what the clients received; then the unload, after which the model
   reads not ready. Requests/s and client latency p50 / p99.
19. trainer: a real job's switches at BERT-Base width (as the training
   phase, SGD lr 0.01, MSE, batch 32), in fp32 and then bf16: one step
   with ``FFConfig(remat_blocks=True)`` (each layer a rematerialized
   block: 24 ``ff_flash_fwd`` launches a step, 12 of dQ and of dK/dV) and
   one with ``grad_accum_steps=4`` (4 strided microbatches of 8: 48 of
   each) against the plain step (12 of each), from the same weights and
   step key, at the training phase's gates (bitwise equality reported);
   peak device memory over a step lower with remat and with
   accumulation; step ms in turns. Then the DataLoader
   (``create_data_loader``: pinned host gathers, copies ``non_blocking``
   from its prefetch thread) feeds 8 shuffled batches into
   ``train_batch``, against the same batches staged on the card (the
   same losses), with each one's ms a step and profiled busy share. Then
   the checkpoint cell: bert-cls at full width with dropout 0.1 trains 4
   steps on explicit keys, ``CheckpointManager(max_to_keep=2)`` saves
   after steps 1 and 2, a fresh process (``chip_smoke.py --resume-child
   DIR``) rebuilds the model from its graph, restores the newest and
   runs steps 3-4: their losses and final parameters equal the
   uninterrupted run's bit for bit; a torn newest falls back to step 1;
   a ``checkpoint.save`` fault leaves no step dir.
20. vision: ResNet-50 at its published ImageNet width (3 x 224 x 224,
   1000 classes, fp32 with TF32 off for cuDNN; SGD lr 0.01, momentum
   0.9, sparse categorical cross-entropy, accuracy): one step at batch 4
   on the card against the same step of the port on the CPU from the
   same weights (loss rtol 1e-4; parameters within 1e-3 of the step's
   largest change; each running statistic within 1e-3 of its largest
   |value|), eval (``predict`` reading the running statistics) against
   the CPU's at atol 1e-4 + rtol 1e-4; warm-up and 10 timed steps at
   batch 32 (images/s, the loss on the fixed batch falling, peak
   memory) and a profiled pair (busy share, device ms by kernel group:
   convolution, BatchNorm and elementwise, GEMM, other); the same step
   with ``remat_blocks`` (stage 3's 5 blocks, BatchNorms inside) against
   without at the card-against-CPU gates, the running statistics moved
   by one update, peak memory lower; one forward each at batch 8 of
   AlexNet (224), ResNeXt-50 32x4d (224) and Inception-v3 (299); and
   ``FFModel.profile`` of ResNet-50's forward at batch 32 (each op alone,
   CUDA events around its second call): the device ms by op type and the
   slowest ops, every op taking time.
   The earlier training phases run eager steps (``fit`` at
   ``trace_window=1``); the window phase holds the captured graph
   against them.
21. window: the executor's window path, each step kind captured once as
   a CUDA graph and replayed once a step, against the eager steps from
   the same weights and keys. BERT-Base (the trainer phase's model, SGD
   lr 0.01, MSE, batch 32) in fp32 and bf16: 16 steps as
   ``fit(trace_window=8)`` (two windows) against 16 ``train_batch``
   calls: every loss and the final parameters bit for bit, one capture,
   12 + 12 + 12 flash launches a step (replays counted); then in turns
   (window, eager, eager, window) host ms a step, a profiled run of each
   (device ms a step, busy share), the capture's seconds and the peak
   memory over a window. bf16 also: ``train_batch_repeated(num_steps=8)``
   and ``eval_window`` / ``evaluate(trace_window=8)`` against eager steps
   (bit for bit), and Adam with ``set_learning_rate`` between two
   windows (no second capture) against eager steps with the same change.
   NMT at ``build_nmt``'s default widths (vocab 32000 both sides, embed 256,
   hidden 256, 2 LSTM layers, length 32, attention; batch 64, SGD lr
   0.01, sparse categorical cross-entropy): a batch-4 step on the card
   against the port on the CPU from the same weights (the training
   phase's fp32 gates), then 16 steps eager against ``trace_window=8``
   as above. DLRM at ``build_dlrm``'s default widths (8 tables x 1,000,000 rows x
   64, bag 1, dense 64, bottom 512-256-64, top 512-256-1; batch 256,
   SGD lr 0.01, MSE): a batch-4 step card against CPU on 10,000-row
   tables, then eager against window at full width (samples/s).
22. moe: the mixture-of-experts MLP at examples/moe.py's shape
   (``build_moe_mlp``: 784 in, 10 classes, 8 experts, k 2, expert hidden
   64, alpha 2.0, lambda_bal 0.04; batch 64, fp32, SGD lr 0.01, sparse
   categorical cross-entropy, weights and data from --seed). The card
   against the CPU port from the same weights: routing first (top-k
   indices equal, the smallest margin between the k-th and the (k+1)-th
   gate value and the dropped slots printed), then one step at the
   training phase's fp32 gates; 16 steps as ``fit(trace_window=8)``
   against 16 ``train_batch`` calls, bit for bit with one capture (host
   ms a step in turns, device ms and busy share, capture s); the batched
   layer against the per-expert one from the same weights (rtol 1e-5,
   atol 1e-6); ``use_cache=True`` with ``recompile_on_condition``: the
   trigger fires on ``cache_score``, the weights are kept bit for bit by
   name, the old executor's graphs are dropped and the next window fit
   captures once and trains; AggregateSpec alone, card against CPU (rows
   and expert gradient bit for bit, gate gradient rtol 1e-5); an
   ``ElasticTrainer`` run with an error injected at ``elastic.step``
   ending bit for bit with the fault-free run; ``FFConfig(profiling=
   True)`` printing the per-op table once.
23. keras: examples/keras_mnist.py's Sequential model (Dense 128 ReLU over
   784, Dropout 0.2, Dense 10 softmax; SGD 0.05, batch 64, 512 samples,
   one epoch) on the card against the same graph on the CPU from the same
   weights and key chain: the dropout masks bit for bit, the first loss
   rtol 1e-5, every loss rtol 1e-4, each parameter within 1e-3 of its
   largest change; the functional CNN of tests/test_keras_frontend.py
   (two convolutions concatenated, Adam, batch 16): eval against the CPU
   (atol 1e-4 + rtol 1e-4), the first loss rtol 1e-5, ``predict`` rows of
   probabilities.
24. onnx: an ONNX BERT-Base as onnxruntime's transformer fusion writes it
   (com.microsoft ``Attention`` nodes; vocab 30522, 12 x 768, 12 heads,
   ff 3072, seq 128, bert-cls's 2-class head; weights from --seed),
   loaded by ``InferenceModel.from_onnx(max_batch=32)`` and served over
   ``/v2/models/bert_onnx/infer`` to 16 clients posting 64 requests of
   1-4 rows: logits against a CPU ``from_onnx`` of the same proto (atol
   1e-4 + rtol 1e-4), each response equal to ``infer`` on its rows, 12
   ``ff_flash_fwd_f32`` launches a device batch, ``/metrics`` counting
   every request; requests/s, client p50 / p99, requests a device batch,
   build-and-load s, device ms of a full batch.
25. fx: tests/test_torch_frontend.py's HF-style BERT encoder at BERT-Base
   width imported by torch.fx (``PyTorchModel``, ``copy_weights``; SGD
   0.05, MSE, batch 32): ``predict`` against the module's own forward on
   the card (atol 1e-4 + rtol 1e-4), the ``.ff`` export replayed as the
   import, four batch-4 steps card against CPU (the first loss rtol 1e-5,
   every loss rtol 1e-4, parameters within 1e-3 of the largest change);
   step ms and samples/s. No hand-written kernel is on this path.
26. search: the Unity strategy search on the card. ``calibrate()`` of
   the default suite (each op's forward captured in a CUDA graph, timed
   by events; the attention entry through ``ff_flash_fwd_bf16`` on the
   wgmma body only): every op measured, each ratio to its roofline
   finite and > 0, the table reloaded unchanged; each ratio and class
   derate printed. BERT-Base bf16 (batch 32, SGD 0.01, MSE, weights from
   --seed) built with ``only_data_parallel`` and with ``search_budget=8``
   and trained 4 steps each: the search ran with the H100 spec and its
   table, axes all 1, the same graph, losses and parameters bit for bit,
   12 of each bf16 flash kernel a step in both; the predicted step
   (``best_cost`` and the task-graph simulator's) beside the measured.
   Then ``unity_optimize`` for 8 H100s (allreduce schedules on): its
   strategy file's ``to_json`` -> ``from_json`` -> ``remap_to`` onto a
   fresh build unchanged, a compile importing it refused with "mesh
   needs 8 devices, have 1" after exporting and before training, and
   the native library (built from ``native/src``) answering the
   simulator's replays with none in Python.
27. programs: the executor's program registry and truth ledger, then the
   card's tools. (a) BERT-Base bf16 (batch 32, seq 128, SGD 0.01, MSE)
   fit as two windows of 8 with the search phase's H100 table as the
   calibration: ``GLOBAL_PROGRAMS`` holds one ``train_window[8]`` trace
   (the capture) and no other program or retrace, one capture in all,
   16 x 12 launches of each bf16 flash kernel, the ledger's
   ``executor[n].train_step`` a prediction from that table and a
   measured pair, ``/v2/debug/programs`` on an ``InferenceServer``
   listing the program; (b) ``tools/mfu_profile.py`` as a child (batch
   32, 8 steps a window): exit 0, bf16 flash launches, flash kernels in
   its groups, the groups summing to the profiled total within 1%, the
   H100's 989 TFLOP/s as the MFU's peak; (c) ``calib_debug``'s steps
   A-E: every figure finite and > 0 (the two intercepts finite), both
   framework ops in the ledger; (d) ``evidence.py --quick``: the
   batch-32 lever recorded, a rerun recording nothing, a child killed
   at its 2 s timeout leaving the file valid with its error; (e) the
   port's C driver compiled with gcc and run on the card: the MLP loop,
   then 2 attention layers at 768 wide, 12 heads, seq 128, batch 8 for
   3 steps: the loss falls, 6 ``ff_flash_bwd_{dq,dkv}_f32`` launches
   and >= 6 forward, the losses equal the same calls through the Python
   API here (rtol 1e-5); (f) fp32 BERT-Base fed by the DataLoader
   (shuffled, 8 batches): every batch equal to ``index_select``'s, the
   native gather answering each, ms a step against staged batches in
   turns and the busy share.

Prints a ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``. Needs one CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 (and fp16) on the tensor cores, H100 SXM data sheet
TF32_PRODUCTS = 3  # TF32 products per fp32-accurate product (3xTF32 split)
ATOL = 1e-4
RTOL = 1e-4
LOGITS_ATOL = 1e-3
SOURCE = "flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu"
FLASH_SOURCE = "flexflow_tpu_torch/ops/kernels/csrc/flash_attention.cu"
LOSS_RTOL = 1e-5  # train-step loss, kernel vs plain attention
# parameters after one SGD step, kernel vs plain attention: within this
# share of the largest update the step made (fp32 summation order only)
PARAM_STEP_RTOL = 1e-3
# bf16 or fp16 outputs of a kernel against its plain version: within one
# unit in the last place of the type at the plain value plus this (both
# sum in fp32, in other orders, and round once to the type)
HALF_ATOL = 1e-3
# the fp16 range cases (check_fp16_range): in place of HALF_ATOL, this
# share of the output's largest |plain value| (about one ulp there), since
# HALF_ATOL would pass outputs of order 1e-6 whatever they held
HALF_RANGE_SHARE = 1e-3
# the 2-byte types: (stored mantissa bits, exponent of the smallest normal)
HALF_BITS = {"bfloat16": (7, -126), "float16": (10, -14)}
# the bf16 and fp16 training steps, kernel vs plain attention: the loss
# within the type's unit roundoff (2^-8, 2^-11) relative; each parameter
# within 2 ulps of the type (the update is rounded once, and the two
# float32 results may straddle a rounding boundary) plus this share of the
# step's largest update (a gradient summed over 4096 rows of 2-byte values
# rounded in other places)
HALF_LOSS_RTOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
HALF_PARAM_SHARE = 1 / 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 16, reps: int = 5):
    """(device ms, eager ms) per call, by CUDA events, cycling over
    ``arg_sets`` (distinct copies of the inputs, together larger than
    the 50 MB L2, so each call reads its K/V from device memory).

    Device ms: ``iters`` calls captured in one CUDA graph and replayed,
    so the time is the device's, free of Python and launch overhead.
    Eager ms: the same calls issued one by one from Python, which on a
    slow host measures the host's issue rate instead."""
    import torch

    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the capture stream's side
        for a in arg_sets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / (reps * iters)
    del graph
    return device, eager


def check_close(name: str, got, want) -> float:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {ATOL} + rtol {RTOL}; "
            f"max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def half_ulp(x, dtype):
    """The spacing of ``dtype`` (bfloat16 or float16) values at |x|, no
    finer than at the type's smallest normal (fp16's subnormals are
    spaced 2^-24), as float32."""
    import torch

    bits, low = HALF_BITS[str(dtype)[6:]]
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))).clamp_min(low)
                      - bits)


def check_half(name: str, got, want, atol: float = HALF_ATOL) -> float:
    """bf16 or fp16 ``got`` against the plain ``want`` of the same type:
    within one ulp of the type at the plain value plus ``atol``.
    Returns the max abs error."""
    import torch

    if (got.shape != want.shape or got.dtype != want.dtype
            or got.dtype not in (torch.bfloat16, torch.float16)):
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs plain "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    bad = err > half_ulp(want, got.dtype) + atol
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond 1 ulp + {atol:.3g}; "
                             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def range_atol(want) -> float:
    """check_half's ``atol`` for an fp16 range case: HALF_RANGE_SHARE of
    the largest |plain value|."""
    return HALF_RANGE_SHARE * float(want.float().abs().max())


# a flash kernel form's launch-count suffix by input dtype name
FLASH_FORMS = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}


def paged_inputs(gen, num_blocks, bs, heads, head_dim, tables_np, qpos_np, copies,
                 kv_dtype=None):
    """``copies`` distinct (q, k_cache, v_cache, block_tables, q_positions)
    sets on the card, sharing tables and positions; fp32 q, caches of
    ``kv_dtype`` (fp32 by default)."""
    import torch

    dev = torch.device("cuda")
    kv_dtype = kv_dtype or torch.float32
    b, w = qpos_np.shape
    tables = torch.from_numpy(tables_np).to(dev)
    qpos = torch.from_numpy(qpos_np).to(dev)
    sets = []
    for _ in range(copies):
        k = torch.randn((num_blocks, bs, heads, head_dim), generator=gen).to(dev, kv_dtype)
        v = torch.randn((num_blocks, bs, heads, head_dim), generator=gen).to(dev, kv_dtype)
        q = torch.randn((b, w, heads, head_dim), generator=gen).to(dev)
        sets.append((q, k, v, tables, qpos))
    return sets


def bound(qpos_np, max_blocks, bs, heads, head_dim, kv_bytes=4):
    """{body: (bound_ms, bound_by)} of one paged append attention call:
    bytes of q, the live K/V rows (each read once, ``kv_bytes`` an
    element), the tables, the positions and the output, over the card's
    memory rate; against the operations QK and PV need for these
    positions, in fp32 on the CUDA cores ("cuda_cores", the fp32 rate)
    or to fp32 accuracy on the tensor cores ("tensor_cores": three TF32
    products each over an fp32 cache, two over a 2-byte one, at the
    dense TF32 rate, as the kernel's tensor-core body takes them)."""
    import numpy as np

    b, w = qpos_np.shape
    live = np.minimum(qpos_np.max(axis=1) + 1, max_blocks * bs).clip(min=0)
    nbytes = (
        4 * 2 * b * w * heads * head_dim  # q in, output out
        + kv_bytes * 2 * int(live.sum()) * heads * head_dim  # K and V rows
        + 4 * (b * max_blocks + b * w)  # tables, positions
    )
    flops = 4 * int((qpos_np + 1).clip(min=0).sum()) * heads * head_dim
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    products = TF32_PRODUCTS if kv_bytes == 4 else TF32_PRODUCTS - 1
    out = {}
    for body, t_ops in (("cuda_cores", flops / H100_FP32_FLOPS * 1e3),
                        ("tensor_cores", products * flops / H100_TF32_FLOPS * 1e3)):
        out[body] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def sdpa_inputs(sets):
    """The library yardstick's inputs: K/V gathered contiguous per
    sequence, [B, H, S, D], in the cache's dtype, q cast to it (for a
    2-byte cache a lower-precision function: a speed yardstick only),
    and the same position mask [B, 1, W, S]."""
    import torch

    out = []
    for q, k, v, tables, qpos in sets:
        b, mb = tables.shape
        kk = k[tables.long()].reshape(b, mb * k.shape[1], *k.shape[2:]).transpose(1, 2)
        vv = v[tables.long()].reshape(b, mb * v.shape[1], *v.shape[2:]).transpose(1, 2)
        pos = torch.arange(kk.shape[2], device=q.device)
        mask = (pos[None, None, :] <= qpos[:, :, None])[:, None]
        out.append((q.to(k.dtype).transpose(1, 2).contiguous(), kk.contiguous(), vv.contiguous(),
                    mask))
    return out


def kv_forms():
    """(cache dtype, launch-count and row suffix) of each paged kernel form:
    fp32, bf16, fp16."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    return tuple((dtype, count) for dtype, (_, count) in da._FORMS.items())


def kernel_phase(seed: int):
    """Each kernel form (fp32, bf16 and fp16 caches) against its plain
    version, then times. Returns the per-kernel records, keyed by shape
    and form suffix (launches filled in by the serving phases)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rs = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    nb, bs, h, d, mb = 257, 16, 12, 64, 64
    copies = 8  # 8 x 2 x 12.6 MB of cache: well past the L2

    def tables_for(ctx_lens):
        t = np.zeros((len(ctx_lens), mb), np.int32)  # past coverage: scratch
        perm = rs.permutation(np.arange(1, nb)).astype(np.int32)
        used = 0
        for i, n in enumerate(ctx_lens):
            nblk = -(-int(n) // bs)
            t[i, :nblk] = perm[used:used + nblk]
            used += nblk
        return t

    cases = {}
    # decode, as the 4-slot engine runs it: mixed context lengths, one
    # inactive slot (context 0), scratch entries past each table's end
    ctx = np.asarray([731, 18, 0, 377], np.int32)
    cases["decode"] = (tables_for(ctx), (ctx - 1)[:, None].astype(np.int32), 1)
    # a W = 5 append window with padding queries and an all-padding slot
    base = np.asarray([700, 40, 0, 300], np.int32)
    qpos = base[:, None] + np.arange(5, dtype=np.int32)[None, :]
    qpos[1, 3:] = -1
    qpos[2, :] = -1
    cases["append_w5"] = (tables_for(base + 5), qpos.astype(np.int32), 1)
    # single-stream long context: the split-KV form, S = default_kv_splits(1, 64)
    splits = da.default_kv_splits(1, mb)
    if splits != 8:
        raise AssertionError(f"default_kv_splits(1, 64) = {splits}, expected 8")
    ctx1 = np.asarray([931], np.int32)
    cases["split"] = (tables_for(ctx1), (ctx1 - 1)[:, None].astype(np.int32), splits)
    # suffix buckets (16, 32, 512) and windows past a query tile (33, 64,
    # 256, 1024), as a suffix prefill gives them: a causal run from
    # `start` (one sixth of the window left as padding), then padding
    # queries (-1)
    for w in (16, 32, 33, 64, 256, 512, 1024):
        for start in (0, 512):
            n_real = min(w - w // 6, mb * bs - start)
            qpos = np.full((1, w), -1, np.int32)
            qpos[0, :n_real] = start + np.arange(n_real)
            cases[f"wide_w{w}_start{start}"] = (tables_for([start + n_real]), qpos, 1)
    # 40- and 41-query verify windows (41: max_spec_tokens = 40) over four
    # slots, with padding queries and an inactive slot
    for w in (40, 41):
        base = np.asarray([640, 120, 0, 300], np.int32)
        qpos = base[:, None] + np.arange(w, dtype=np.int32)[None, :]
        qpos[1, 20:] = -1
        qpos[2, :] = -1
        cases[f"verify_w{w}"] = (tables_for(base + w), qpos.astype(np.int32), 1)
    # the split form over a 64-query window
    qpos = np.full((1, 64), -1, np.int32)
    qpos[0, :54] = 700 + np.arange(54)
    cases["split_w64"] = (tables_for([754]), qpos, splits)

    rows = {}
    for (kv_dtype, form), (case, (tables, qpos, s)) in itertools.product(kv_forms(),
                                                                         cases.items()):
        name = case + form
        sets = paged_inputs(gen, nb, bs, h, d, tables, qpos, copies, kv_dtype)
        q, k, v, bt, qp = sets[0]
        got = da.paged_append_attention(q, k, v, bt, qp, kv_splits=s)
        want = da.reference_paged_append_attention(q, k, v, bt, qp)
        if s == 1:
            err = check_close(f"{name} kernel vs plain", got, want)
            plain = da.reference_paged_append_attention
        else:
            def plain(q_, k_, v_, bt_, qp_, s=s):
                return da._combine_splits(
                    *da.reference_paged_append_partials(q_, k_, v_, bt_, qp_, s),
                    qp_, q_.dtype,
                )

            err = max(check_close(f"{name} kernel vs plain split + combine", got,
                                  plain(q, k, v, bt, qp)),
                      check_close(f"{name} kernel vs single-pass plain", got, want))
        pad = torch.from_numpy(qpos < 0).cuda()
        if pad.any() and not bool((got[pad] == 0).all()):
            raise AssertionError(f"{name}: padding queries must give exact zeros")
        ms, eager_ms = time_ms(lambda *a: da.paged_append_attention(*a, kv_splits=s), sets)
        plain_ms, plain_eager_ms = time_ms(plain, sets)
        lib_sets = sdpa_inputs(sets[:4])
        library_ms, _ = time_ms(
            lambda qq, kk, vv, mask: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask),
            lib_sets,
        )
        # the body this window runs, and its bound; the other body's beside it
        body = da.kernel_body(qpos.shape[1], d)
        bounds = bound(qpos, mb, bs, h, d, kv_bytes=k.element_size())
        bound_ms, bound_by = bounds[body]
        # blocks per (head, sequence) of the split kernel, or of the
        # single-pass CUDA-core body (the tensor-core body sizes its own)
        ctas = (da.split_plan(s, mb)[0] if s > 1
                else da.kernel_cluster_size(mb, bs) if body == "cuda_cores" else None)
        rows[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "body": body,
            "cuda_core_bound_ms": bounds["cuda_cores"][0],
            "tensor_core_bound_ms": bounds["tensor_cores"][0],
            "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
            "shape": {"B": int(qpos.shape[0]), "W": int(qpos.shape[1]), "H": h, "D": d,
                      "bs": bs, "MB": mb, "splits": s, "ctas_per_head": ctas,
                      "kv_dtype": str(kv_dtype).replace("torch.", ""),
                      "live_positions": int(np.minimum(qpos.max(1) + 1, mb * bs).clip(0).sum())},
        }
        print(f"kernel {name}: " + json.dumps(rows[name]))
        del sets, lib_sets
    edge_shapes(seed)
    torch.cuda.empty_cache()
    return rows


def device_kernels(fn, calls: int) -> list:
    """Names of the device kernels that ``calls`` calls of ``fn`` run, as
    torch.profiler records them (after a warm-up call). The profiler can
    drop events at the edges of its window, so a caller checks what the
    recorded kernels are, not that each call's last one is there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def edge_shapes(seed: int) -> None:
    """Correctness only, off the serving path's shapes: the widest window
    and head_dim the kernel takes, a head_dim that is not a multiple of 4
    (4-byte copies), odd block sizes, a cluster that does not divide the
    table, split counts that do not divide it, 16 splits and as many
    splits as columns (blocks taking several splits each), a padding-only
    sequence, contexts that leave blocks of a cluster without a live
    position (0, 1, 15, 16, 17, and one position into the second block's
    share) beside a long one, and a table of 60000 columns through the
    single-pass kernel and the split kernel — each against the plain
    version, every case in the fp32, bf16 and fp16 forms (the wide table
    in fp32 and bf16); padding queries must give exact zeros."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rs = np.random.RandomState(seed + 7)
    gen = torch.Generator().manual_seed(seed + 7)

    def check(tag, tables, qpos, h, d, bs, s, forms=kv_forms()):
        for kv_dtype, form in forms:
            check_form(f"{tag}{form}", tables, qpos, h, d, bs, s, kv_dtype)

    def check_form(tag, tables, qpos, h, d, bs, s, kv_dtype):
        q, k, v, bt, qp = paged_inputs(gen, tables.shape[0] * tables.shape[1] + 1, bs, h, d,
                                       tables, qpos, 1, kv_dtype)[0]
        got = da.paged_append_attention(q, k, v, bt, qp, kv_splits=s)
        want = da.reference_paged_append_attention(q, k, v, bt, qp)
        err = check_close(f"edge shape {tag}", got, want)
        if s > 1:
            partials = da.reference_paged_append_partials(q, k, v, bt, qp, s)
            err = max(err, check_close(f"edge shape {tag} vs plain split + combine", got,
                                       da._combine_splits(*partials, qp, q.dtype)))
            del partials
        pad = torch.from_numpy(qpos < 0).cuda()
        if not bool((got[pad] == 0).all()):
            raise AssertionError(f"edge shape {tag}: padding queries must give exact zeros")
        ctas = (da.kernel_cluster_size(tables.shape[1], bs) if s == 1
                else da.split_plan(s, tables.shape[1])[0])
        print(f"kernel edge shape {tag} ({ctas} blocks a head): max abs err {err:.3e}")

    # (B, W, H, D, bs, MB, splits); the second: a 3-block cluster over 61
    # columns; from the fourth: split counts that do not divide the table,
    # 16 splits and as many splits as columns; the last two: windows of two
    # and of four query tiles (D = 256, odd block sizes)
    for b, w, h, d, bs, mb, s in [
        (2, 32, 2, 256, 8, 12, 1),
        (3, 32, 2, 256, 5, 61, 1),
        (3, 17, 3, 100, 5, 20, 1),
        (2, 3, 4, 128, 7, 30, 4),
        (1, 1, 1, 1, 1, 9, 2),
        (2, 1, 12, 64, 16, 64, 16),
        (2, 1, 12, 64, 16, 64, 64),
        (3, 5, 4, 100, 7, 30, 30),
        (3, 32, 2, 256, 5, 61, 7),
        (2, 33, 2, 256, 5, 30, 1),
        (3, 100, 4, 64, 7, 40, 5),
        # head dims past 256 (the 512-wide instances): decode, verify
        # window, split, and a 32-query tile at D = 384
        (2, 1, 2, 512, 16, 20, 1),
        (2, 5, 2, 512, 16, 20, 1),
        (2, 5, 2, 512, 16, 20, 4),
        (2, 40, 2, 384, 8, 12, 1),
    ]:
        nb = b * mb + 1
        tables = rs.randint(1, nb, (b, mb)).astype(np.int32)
        tables[:, -1] = 0
        base = rs.randint(0, mb * bs - w, b)
        qpos = (base[:, None] + np.arange(w)[None, :]).astype(np.int32)
        qpos[rs.rand(b, w) < 0.2] = -1
        if b > 2:
            qpos[-1] = -1  # a padding-only sequence
        check(f"B={b} W={w} H={h} D={d} bs={bs} MB={mb} S={s}", tables, qpos, h, d, bs, s)
    # a window of padding only, two query tiles wide, through both kernels
    tables = rs.randint(1, 17, (2, 8)).astype(np.int32)
    for s in (1, 4):
        check(f"all padding B=2 W=70 S={s}", tables, np.full((2, 70), -1, np.int32), 4, 64, 16, s)
    # decode over 64 columns of 16 (8 blocks of 128 positions a cluster)
    mb, bs = 64, 16
    for ctx in (0, 1, 15, 16, 17, 129):
        tables = rs.permutation(np.arange(1, 2 * mb + 1)).reshape(2, mb).astype(np.int32)
        qpos = np.asarray([[ctx - 1], [730]], np.int32)
        check(f"decode contexts {ctx} and 731, MB={mb} bs={bs}", tables, qpos, 12, 64, bs, 1)
        # the split form, whose blocks take fixed column ranges: short
        # contexts leave most of them empty
        check(f"split decode contexts {ctx} and 731, MB={mb} bs={bs}", tables, qpos, 12, 64, bs,
              da.default_kv_splits(2, mb))
    # a table of 60000 columns of one position: a block of either kernel
    # holds at most 2048 table columns in shared memory and reads the rest
    # from device memory
    mb = 60000
    tables = rs.randint(1, mb + 1, (1, mb)).astype(np.int32)
    qpos = np.asarray([[57000, 59999, -1]], np.int32)
    for s in (1, 16, mb):
        check(f"wide table B=1 W=3 H=2 D=64 bs=1 MB={mb} S={s}", tables, qpos, 2, 64, 1, s,
              kv_forms()[:2])


def gpt2_small():
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        num_layers=12, hidden_size=768, num_heads=12, ff_size=3072,
        seq_length=1024, vocab_size=50257, causal=True,
    )


def check_decode_logits(engine, sched, name: str) -> float:
    """Recompute one decode step of the scheduler's live batch twice, on
    clones of the cache: through the kernel path and through the plain
    attention. The logits must agree within LOGITS_ATOL."""
    import torch

    from flexflow_tpu_torch.generation.decoder import decode_step

    order = sorted(sched._running.values(), key=lambda s: s.slot)
    if not order:
        raise AssertionError(f"{name}: no running sequence to check")
    tokens, positions, tables, active = sched._collect_slots(order)[:4]
    x = engine.decode_arrays(tokens, positions, tables, active)
    tok, pos, bt, ctx = (torch.from_numpy(x[k]).to(engine.device)
                         for k in ("tokens", "positions", "tables", "context_lens"))
    out = {}
    for backend in ("auto", "plain"):
        ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
        logits, _, _ = decode_step(engine.params, tok, pos, ck, cv, bt, ctx, backend=backend)
        out[backend] = logits[torch.from_numpy(active).to(logits.device)]
        del ck, cv
    k, p = out["auto"], out["plain"]
    if k.shape != (len(order), engine.cfg.vocab_size) or not torch.isfinite(k).all():
        raise AssertionError(f"{name}: logits {tuple(k.shape)} not finite / wrong shape")
    err = float((k - p).abs().max())
    scale = float(p.abs().max())
    print(f"{name}: decode logits kernel vs plain attention: max abs err {err:.3e} "
          f"(logits up to {scale:.2f}, {len(order)} live slots)")
    if err > LOGITS_ATOL:
        raise AssertionError(f"{name}: logits differ by {err} > {LOGITS_ATOL}")
    torch.cuda.empty_cache()
    return err


def serve(engine, prompts, samplings, speculation=None, overlap=None):
    """Submit every prompt at once and step the scheduler (the overlap
    pipeline on unless ``overlap=False``) to the end. Returns (handles,
    wall seconds, per-request TTFT seconds, scheduler)."""
    import torch

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    t0 = time.perf_counter()
    handles = [sched.submit(p, s, speculation=speculation) for p, s in zip(prompts, samplings)]
    ttft = [None] * len(handles)
    for _ in range(10_000):
        if all(h.done() for h in handles):
            break
        sched.step()  # tokens of this or the previous step come back to the host
        now = time.perf_counter()
        for i, h in enumerate(handles):
            if ttft[i] is None and h._request.generated:
                ttft[i] = now - t0
    wall = time.perf_counter() - t0
    if not all(h.done() for h in handles):
        raise AssertionError("requests did not finish")
    return handles, wall, ttft, sched


def warm(engine, rs, speculation=None) -> None:
    """A prompt in every prefill bucket through the engine (and decode
    steps, and verify steps with ``speculation``), so every step
    signature is captured — and cuBLAS and the allocator warmed — before
    a timed run."""
    from flexflow_tpu_torch.generation.engine import SamplingParams

    lens = [min(b, engine.max_seq_len - 8) for b in engine.buckets]
    engine.generate([rs.randint(0, engine.cfg.vocab_size, n).tolist() for n in lens],
                    SamplingParams(max_new_tokens=4), speculation=speculation)


def engine_pair(params, **kw):
    """{"graph": an engine replaying captured CUDA graphs (the default),
    "eager": the same engine with eager steps}, sharing the weights. The
    prefix cache is off unless ``prefix_cache=True`` is passed: the
    serving, long-context, step-graph and speculation phases repeat their
    prompts across runs and engines, and with the cache on a repeat would
    reuse the earlier run's blocks (the prefix phase measures that path)."""
    from flexflow_tpu_torch.generation.engine import GenerationEngine

    cfg = gpt2_small()
    kw.setdefault("prefix_cache", False)
    return {"graph": GenerationEngine(params, cfg, **kw),
            "eager": GenerationEngine(params, cfg, eager_steps=True, **kw)}


def run_stats(engine, handles, wall, ttft, decode0, dsec0, launches) -> dict:
    """A timed scheduler run's numbers (engine counters read before it:
    decode0 steps, dsec0 seconds). ``decode_call_ms`` is the engine's
    host time inside its decode calls per step (``step_seconds``): a whole
    step on the sequential loop, but only the dispatch and the wait at
    consume on the overlap pipeline, so it is not a step time there; the
    overlap phase's steady stretch gives the step time, on and off."""
    import numpy as np

    steps = engine.step_counts["decode"] - decode0
    tokens = sum(len(h.result(0)) for h in handles)
    return {"decode_steps": steps, "launches": launches, "wall_s": wall,
            "new_tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": float(max(ttft)),
            "decode_call_ms": 1e3 * (engine.step_seconds["decode"] - dsec0) / max(steps, 1)}


def serving_phase(seed: int, params):
    """The 4-slot engine behind the scheduler: 8 mixed requests, through
    the graph engine and the eager engine in turns (graph, eager, eager,
    graph). Returns (engines, stats, (prompts, samplings, streams))."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=4, block_size=16)
    if engines["graph"].cache_config.num_blocks != 257:
        raise AssertionError(f"cache holds {engines['graph'].cache_config.num_blocks} blocks, "
                             "expected 257")
    rs = np.random.RandomState(seed)
    for engine in engines.values():
        warm(engine, rs)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 6 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    runs, streams = {"graph": [], "eager": []}, None
    for name in ("graph", "eager", "eager", "graph"):
        engine = engines[name]
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, _ = serve(engine, prompts, samplings)
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        outs = [h.result(0) for h in handles]
        for out in outs:
            if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"bad stream {out}")
        steps = stats["decode_steps"]
        if launches["paged_append"] != cfg.num_layers * steps or launches["paged_append_split"]:
            raise AssertionError(
                f"{name}: launches {launches} != {cfg.num_layers} layers x {steps} decode steps")
        if streams is None:
            streams = outs
        elif outs != streams:
            raise AssertionError(f"{name} engine's streams differ from the graph engine's")
        runs[name].append(stats)
        print(f"serving (4 slots, {name} steps): " + json.dumps(stats))
    graph = engines["graph"]
    if graph.trace_counts.get("decode") != 1 or graph.recompiles():
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    stats = {"requests": len(prompts), "prompt_lens": lens, "graph": runs["graph"],
             "eager": runs["eager"], "launches": runs["graph"][0]["launches"],
             "captures": dict(graph.trace_counts)}
    # a live batch's decode step, kernel vs plain attention
    sched = ContinuousBatchingScheduler(graph)
    extra = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(), SamplingParams(max_new_tokens=4))
             for n in (100, 37, 250, 16)]
    sched.step()
    stats["logits_max_abs_err"] = check_decode_logits(graph, sched, "serving")
    while not all(h.done() for h in extra):
        sched.step()
    return engines, stats, (prompts, samplings, streams)


def decode_window_profile(engine, seed: int, steps: int = 8) -> dict:
    """``steps`` decode steps of four live slots under torch.profiler:
    device and wall ms a step, the device's busy share of the wall,
    device kernels a step, and num_layers paged kernels a step. The steps
    run sequentially (``overlap=False``): with a replay queued behind a
    running one, the profiler now and then drops a run of kernel records
    (``flexflow_tpu_torch/tools/profile_loss_probe.py`` counts
    such windows, pipelined and sequential), and the kernel count per
    step below is exact."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 4)
    sched = ContinuousBatchingScheduler(engine, overlap=False)
    handles = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(),
                            SamplingParams(max_new_tokens=steps + 4)) for n in (300, 64, 700, 128)]
    sched.step()  # the four prefills and a first decode
    torch.cuda.synchronize()
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = engine.step_counts["decode"] - decode0
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    paged = sum("paged_append_kernel" in e.name for e in ops)
    if n != steps or paged != cfg.num_layers * n:
        raise AssertionError(f"profiled: {paged} paged kernels in {n} decode steps")
    device_us = sum(e.time_range.elapsed_us() for e in ops)
    while not all(h.done() for h in handles):
        sched.step()
    return {"decode_steps": n, "device_ms_per_step": device_us / 1e3 / n,
            "wall_ms_per_step": 1e3 * wall / n, "device_busy_share": device_us / 1e6 / wall,
            "device_ops_per_step": len(ops) / n, "paged_kernels_per_step": paged / n}


def anatomy_phase(engines, seed: int):
    """Where a serving run's time goes: torch.profiler over a short run
    of the 4-slot graph engine (4 requests, 16 new tokens each). Reports
    the device's busy share of the wall time (the sum of the GPU kernel
    and copy durations over the run's wall, profiler overhead included in
    the wall) and the device time by kernel name; then a window of decode
    steps alone, replayed and eager. ``device_busy_share`` is null where
    the profiler saw no device activity."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams

    engine = engines["graph"]
    rs = np.random.RandomState(seed + 2)
    prompts = [rs.randint(0, engine.cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    samplings = [SamplingParams(max_new_tokens=16)] * 3 + [
        SamplingParams(max_new_tokens=16, temperature=0.8, top_k=50, seed=99)
    ]
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _, _ = serve(engine, prompts, samplings)
    steps = engine.step_counts["decode"] - decode0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    stats = {
        "wall_s": wall, "decode_steps": steps,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": (busy_us / 1e6 / wall) if busy_us > 0 else None,
        "top_device_us": {name[:80]: us for name, us in top},
    }
    print("anatomy (profiled, 4 slots, graph steps): " + json.dumps(stats))
    for name in ("graph", "eager"):
        stats[f"decode_window_{name}"] = decode_window_profile(engines[name], seed)
        print(f"anatomy: profiled decode steps, 4 live slots, {name} steps: "
              + json.dumps(stats[f"decode_window_{name}"]))
    return stats


def long_context_phase(seed: int, params):
    """One ~900-token stream in a 1-slot engine: the split-KV kernel,
    graph and eager steps in turns. Returns (stats, graph engine)."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=1, block_size=16)
    rs = np.random.RandomState(seed + 1)
    for engine in engines.values():
        warm(engine, rs)
    prompt = rs.randint(0, cfg.vocab_size, 900).tolist()
    runs, stream = {"graph": [], "eager": []}, None
    for name in ("graph", "eager", "eager", "graph"):
        engine = engines[name]
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, _ = serve(engine, [prompt], [SamplingParams(max_new_tokens=32)])
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        steps = stats["decode_steps"]
        if launches["paged_append_split"] != cfg.num_layers * steps or steps == 0:
            raise AssertionError(
                f"split launches {launches} != {cfg.num_layers} layers x {steps} decode steps")
        if launches["paged_append"] != 0:
            raise AssertionError(f"single-pass kernel ran in the 1-slot engine: {launches}")
        out = handles[0].result(0)
        if stream is None:
            stream = out
        elif out != stream:
            raise AssertionError(f"{name} engine's long-context stream differs")
        runs[name].append(stats)
        print(f"long context (1 slot, {name} steps): " + json.dumps(stats))
    graph = engines["graph"]
    stats = {"prompt_len": len(prompt), "graph": runs["graph"], "eager": runs["eager"],
             "launches": runs["graph"][0]["launches"]}
    sched = ContinuousBatchingScheduler(graph)
    h = sched.submit(rs.randint(0, cfg.vocab_size, 880).tolist(), SamplingParams(max_new_tokens=4))
    sched.step()
    stats["logits_max_abs_err"] = check_decode_logits(graph, sched, "long context")
    while not h.done():
        sched.step()
    return stats, graph


def long_context_profile(engine, seed: int) -> dict:
    """A second ~880-token stream in the long-context graph engine, its
    replayed decode steps under torch.profiler: device time and device
    kernels per step, with one paged kernel a layer; then attention calls
    of that stream over the engine's cache, whose device kernels must all
    be the paged kernel (the split path runs no PyTorch op after its
    launch). Run after the timed phases and the anatomy: a profiler, once
    started, slows the host's later launches. The steps run sequentially,
    for the reason :func:`decode_window_profile` gives."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 3)
    sched = ContinuousBatchingScheduler(engine, overlap=False)
    h = sched.submit(rs.randint(0, cfg.vocab_size, 880).tolist(), SamplingParams(max_new_tokens=12))
    sched.step()  # the prefill
    # the stream's table and positions at the first profiled step
    x = engine.decode_arrays(*sched._collect_slots(list(sched._running.values()))[:4])
    bt = torch.from_numpy(x["tables"]).cuda()
    qp = torch.from_numpy(x["context_lens"][:, None] - 1).cuda()
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        while not h.done():
            sched.step()
    steps = engine.step_counts["decode"] - decode0
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    paged = sum("paged_append_kernel" in e.name for e in ops)
    if steps == 0 or paged != cfg.num_layers * steps:
        raise AssertionError(f"profiled: {paged} paged kernels in {steps} decode steps")
    stats = {
        "decode_steps": steps,
        "device_ms_per_step": sum(e.time_range.elapsed_us() for e in ops) / 1e3 / steps,
        "device_ops_per_step": len(ops) / steps,
        "paged_kernels_per_step": paged / steps,
    }
    print("long context, profiled replayed decode steps: " + json.dumps(stats))
    splits = da.default_kv_splits(bt.shape[0], bt.shape[1])
    q = torch.randn((bt.shape[0], 1, cfg.num_heads, cfg.hidden_size // cfg.num_heads),
                    device=bt.device)
    calls = 10
    launched = device_kernels(lambda: da.paged_append_attention(
        q, engine.cache.k[0], engine.cache.v[0], bt, qp, kv_splits=splits), calls)
    others = sorted({n[:60] for n in launched if "paged_append_kernel" not in n})
    if splits < 2 or not launched or others:
        raise AssertionError(f"{calls} split-path calls (S={splits}) ran {len(launched)} device "
                             f"kernels, other than the paged kernel: {others}")
    stats["split_calls_profiled"] = calls
    stats["split_call_device_kernels"] = sorted({n[:80] for n in launched})
    stats["split_call_kernels_recorded"] = len(launched)
    return stats


def suffix_prefill_bodies(seed: int, params) -> dict:
    """The prefix cell's long suffix in each cache form: a 700-token
    suffix after a cached 64-token prefix (suffix bucket W = 1024) through
    a 4-slot graph engine over an fp32, a bf16 and an fp16 cache. The
    suffix prefill replayed from its graph runs under torch.profiler: its
    device kernels must include the paged kernel's tensor-core body of
    the cache's form (by name) and no CUDA-core paged kernel. Reports that
    step's device ms (CUDA events) and the form's launches by window over
    the run (the counts set to 0 just before it). Run after the timed
    phases: a profiler, once started, slows the host's later launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.cache import CacheConfig
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    layers, v = cfg.num_layers, cfg.vocab_size
    rs = np.random.RandomState(seed + 13)
    system = rs.randint(0, v, 64).tolist()
    one = SamplingParams(max_new_tokens=1)
    out = {}
    for dtype, ctype, form in ((DataType.FLOAT, "float", ""),
                               (DataType.BFLOAT16, "__nv_bfloat16", "_bf16"),
                               (DataType.HALF, "__half", "_f16")):
        cc = CacheConfig(num_layers=layers, num_heads=cfg.num_heads,
                         head_dim=cfg.hidden_size // cfg.num_heads, num_blocks=257,
                         block_size=16, dtype=dtype)
        engine = GenerationEngine(params, cfg, cache_config=cc, max_batch_slots=4,
                                  prefix_cache=True)
        prefill_one, seen = engine.prefill_one, {}

        def profiled(prompt, *a, prefix_len=0, **kw):
            if prefix_len == 0 or "names" in seen:
                return prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start.record()
                token = prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
                end.record()
                torch.cuda.synchronize()
            seen["bucket"] = engine.bucket_for(len(prompt) - prefix_len)
            seen["ms"] = start.elapsed_time(end)
            seen["names"] = sorted({e.name for e in prof.events()
                                    if e.device_type == torch.autograd.DeviceType.CUDA
                                    and "paged_append" in e.name})
            return token

        prompts = [system + rs.randint(0, v, 700).tolist() for _ in range(3)]
        engine.generate(prompts[:1], one)  # registers the prefix's blocks
        engine.generate(prompts[1:2], one)  # the suffix prefill's capture
        engine.prefill_one = profiled
        da.reset_launch_counts()
        engine.generate(prompts[2:], one)  # its replay, profiled
        engine.prefill_one = prefill_one
        names = seen.get("names", [])
        tc = [n for n in names if f"paged_append_tc_kernel<{ctype}, false, 64>" in n]
        if seen.get("bucket") != 1024 or not tc or len(tc) != len(names):
            raise AssertionError(f"{ctype} cache: the W = 1024 suffix prefill (bucket "
                                 f"{seen.get('bucket')}) ran paged kernels {names}, expected "
                                 "the tensor-core body only")
        by_window = {k: n for k, n in da.LAUNCHES_BY_WINDOW.items() if n}
        if by_window != {f"paged_append{form} W>=9": layers}:
            raise AssertionError(f"{ctype} cache: launches by window {by_window}, expected "
                                 f"{layers} of the wide body")
        out[ctype] = {"bucket": seen["bucket"], "suffix_prefill_device_ms": seen["ms"],
                      "device_kernels": [n[:90] for n in names],
                      "launches_by_window": by_window, "launches": dict(da.LAUNCHES)}
        print(f"suffix prefill W=1024, {ctype} cache: " + json.dumps(out[ctype]))
        del engine
        torch.cuda.empty_cache()
    return out


def step_graph_phase(engines, seed: int) -> dict:
    """White box, at GPT-2-small width: the same prefill, decode and
    verify steps on the graph engine and the eager engine (the serving
    phase's, warmed) must give the same tokens, logits and KV cache bit
    for bit; each replay counts num_layers paged launches. Then the
    device time of the threefry Gumbel draws of a decode step and of a
    verify step."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation import prng
    from flexflow_tpu_torch.generation.engine import SamplingParams, derive_keys, derive_window_keys
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    graph, eager = engines["graph"], engines["eager"]
    cfg, b, w = graph.cfg, graph.max_batch_slots, graph.spec_window
    layers, mb = cfg.num_layers, graph.max_blocks_per_seq
    rs = np.random.RandomState(seed + 6)
    lens = (40, 100, 300, 700)
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=50, seed=3),
           SamplingParams(), SamplingParams(temperature=1.0, seed=2**31 + 7)]
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b,), np.int32)
    held = []
    for i, (n, sp) in enumerate(zip(lens, sps)):
        prompt = rs.randint(0, cfg.vocab_size, n).tolist()
        blocks = graph.allocator.allocate(graph.cache_config.blocks_for(n + 40))
        held += blocks
        tables[i, : len(blocks)] = blocks
        tokens[i] = graph.prefill_one(prompt, blocks, sp, 0)
        if eager.prefill_one(prompt, blocks, sp, 0) != tokens[i] or not torch.equal(
                graph.last_logits, eager.last_logits):
            raise AssertionError(f"prefill[{graph.bucket_for(n)}]: replay differs from eager")
    positions = np.asarray(lens, np.int32)
    active = np.ones((b,), bool)
    temps = np.asarray([sp.temperature for sp in sps], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps], np.int32)
    seeds = np.asarray([sp.seed & 0xFFFFFFFF for sp in sps], np.uint32)
    kinds = {"decode": 0, "verify": 0}
    for step in range(8):
        counts = np.full((b,), 1 + step, np.int32)
        args = (tokens, positions, tables, active, temps, top_ks, seeds, counts)
        da.reset_launch_counts()
        out = graph.decode(*args)
        if da.LAUNCHES["paged_append"] != layers:
            raise AssertionError(f"a decode replay counted {da.LAUNCHES}, expected {layers}")
        if not np.array_equal(out, eager.decode(*args)) or not torch.equal(
                graph.last_logits, eager.last_logits):
            raise AssertionError(f"decode step {step}: replay differs from eager")
        kinds["decode"] += 1
        tokens, positions = out.astype(np.int32), positions + 1
    for step, nd in enumerate(([4, 2, 0, 4], [1, -1, 4, 3], [4, 4, 4, 4])):
        n_draft = np.asarray(nd, np.int32)
        window = np.zeros((b, w), np.int32)
        window[:, 0] = tokens
        window[:, 1:] = rs.randint(0, cfg.vocab_size, (b, w - 1))
        counts = np.full((b,), 20 + step, np.int32)
        args = (window, positions, n_draft, tables, temps, top_ks, seeds, counts)
        da.reset_launch_counts()
        out, n = graph.verify(*args)
        if step > 0 and da.LAUNCHES["paged_append"] != layers:
            raise AssertionError(f"a verify replay counted {da.LAUNCHES}, expected {layers}")
        eout, en = eager.verify(*args)
        if not (np.array_equal(out, eout) and np.array_equal(n, en)
                and torch.equal(graph.last_logits, eager.last_logits)):
            raise AssertionError(f"verify step {step}: replay differs from eager")
        kinds["verify"] += 1
        positions = positions + np.where(n_draft >= 0, n, 0)
        tokens = out[np.arange(b), np.maximum(n - 1, 0)].astype(np.int32)
    idx = torch.tensor(held, device=graph.device)  # the blocks these steps wrote
    if not (torch.equal(graph.cache.k[:, idx], eager.cache.k[:, idx])
            and torch.equal(graph.cache.v[:, idx], eager.cache.v[:, idx])):
        raise AssertionError("the KV caches of the graph and eager engines differ")
    graph.allocator.free(held)
    if graph.recompiles() or graph.trace_counts.get("verify") != 1:
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    # the threefry draws on the device, alone (a CUDA graph of 16 calls)
    dev = graph.device
    s_t = torch.from_numpy(seeds.astype(np.int64)).to(dev)
    c_t = torch.arange(b, dtype=torch.int32, device=dev)
    v = cfg.vocab_size
    decode_draw_ms, _ = time_ms(lambda s, c: prng.gumbel(derive_keys(s, c), (v,)), [(s_t, c_t)])

    def verify_draws(s, c):
        keys = derive_window_keys(s, c, w)
        return prng.gumbel(prng.fold_in(keys, 2), (v,)), prng.gumbel(keys, (v,))

    verify_draw_ms, _ = time_ms(verify_draws, [(s_t, c_t)])
    stats = {"checked": {"prefill_buckets": sorted({graph.bucket_for(n) for n in lens}), **kinds},
             "bit_identical": True, "captures": dict(graph.trace_counts),
             "threefry_decode_ms": decode_draw_ms, "threefry_verify_ms": verify_draw_ms}
    print("step graphs: " + json.dumps(stats))
    return stats


def check_verify_logits(engine, sched) -> float:
    """The scheduler's next verify step of its live batch (the drafter's
    proposals, padded with random tokens to as many drafts as the slot's
    blocks hold) on clones of the cache, through the kernel path and the
    plain attention: the logits at every real window position must agree
    within LOGITS_ATOL."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import verify_step

    sched._plan_speculation()
    sched._grow()  # blocks for each slot's next window, as step() grows them
    order = sorted(sched._running.values(), key=lambda s: s.slot)
    last, start, tables = sched._collect_slots(order)[:3]
    b, w = engine.max_batch_slots, engine.spec_window
    bs = engine.cache_config.block_size
    rs = np.random.RandomState(17)
    window = rs.randint(0, engine.cfg.vocab_size, (b, w)).astype(np.int32)
    window[:, 0] = last
    n_draft = np.full((b,), -1, np.int32)
    for state in order:
        req = state.req
        draft = req.drafter.propose(req.original_prompt + req.generated, w - 1) if req.drafter else []
        window[state.slot, 1: 1 + len(draft)] = draft
        # positions past the slot's blocks would map to scratch block 0,
        # where the slots' writes collide and land in any order
        n_draft[state.slot] = min(w - 1, len(state.blocks) * bs - state.cached_len - 1)
    offs = np.arange(w)[None, :]
    positions = np.where(offs <= n_draft[:, None], start[:, None] + offs, -1).astype(np.int32)
    dev = engine.device
    out = {}
    for backend in ("auto", "plain"):
        ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
        logits, _, _ = verify_step(engine.params, torch.from_numpy(window).to(dev),
                                   torch.from_numpy(positions).to(dev), ck, cv,
                                   torch.from_numpy(tables).to(dev), backend=backend)
        out[backend] = logits[torch.from_numpy(positions >= 0).to(dev)]
        del ck, cv
    if not torch.isfinite(out["auto"]).all():
        raise AssertionError("verify logits not finite")
    err = float((out["auto"] - out["plain"]).abs().max())
    print(f"speculation: verify logits kernel vs plain attention: max abs err {err:.3e} "
          f"({out['auto'].shape[0]} window positions, drafts {n_draft.tolist()})")
    if err > LOGITS_ATOL:
        raise AssertionError(f"verify logits differ by {err} > {LOGITS_ATOL}")
    torch.cuda.empty_cache()
    return err


def speculation_phase(seed: int, params) -> dict:
    """4 slots, k = 4, the n-gram drafter: 4 prompts of repeated segments,
    48 new greedy tokens each, plain and then speculative through the
    graph and the eager engines."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=4, block_size=16, max_spec_tokens=4)
    spec = SpeculationConfig(k=4)
    rs = np.random.RandomState(seed + 5)
    for engine in engines.values():
        warm(engine, rs)
        warm(engine, rs, speculation=spec)
    prompts = []
    for seg_len, reps in ((24, 4), (40, 3), (16, 6), (60, 2)):
        seg = rs.randint(0, cfg.vocab_size, seg_len).tolist()
        prompts.append(seg * reps + seg[:6])
    greedy = [SamplingParams(max_new_tokens=48)] * len(prompts)
    graph = engines["graph"]
    da.reset_launch_counts()
    decode0, dsec0 = graph.step_counts["decode"], graph.step_seconds["decode"]
    handles, wall, ttft, _ = serve(graph, prompts, greedy)
    plain = run_stats(graph, handles, wall, ttft, decode0, dsec0, dict(da.LAUNCHES))
    plain_streams = [h.result(0) for h in handles]
    print("speculation: plain greedy (graph steps): " + json.dumps(plain))
    runs = {}
    for name in ("graph", "eager"):
        engine = engines[name]
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        verify0, vsec0 = engine.step_counts["verify"], engine.step_seconds["verify"]
        da.reset_launch_counts()
        handles, wall, ttft, sched = serve(engine, prompts, greedy, speculation=spec)
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        vsteps = engine.step_counts["verify"] - verify0
        steps = stats["decode_steps"] + vsteps
        if [h.result(0) for h in handles] != plain_streams:
            raise AssertionError(f"{name}: speculative greedy streams differ from plain ones")
        if launches["paged_append"] != cfg.num_layers * steps or launches["paged_append_split"]:
            raise AssertionError(f"{name}: launches {launches} != {cfg.num_layers} layers x "
                                 f"({stats['decode_steps']} decode + {vsteps} verify steps)")
        c = sched.spec_stats.counts()
        stats.update({
            "verify_steps": vsteps,
            "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vsec0) / max(vsteps, 1),
            "drafted": c["proposed"], "accepted": c["accepted"],
            "acceptance_rate": c["accepted"] / max(c["proposed"], 1),
            "tokens_per_verify_step": c["emitted"] / max(vsteps, 1),
            "tokens_per_slot_window": c["emitted"] / max(c["windows"], 1),
        })
        runs[name] = stats
        print(f"speculation (k=4, n-gram, {name} steps): " + json.dumps(stats))
    if graph.trace_counts.get("verify") != 1 or graph.recompiles():
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    # a live speculating batch: decode and verify logits, kernel vs plain
    sched = ContinuousBatchingScheduler(graph)
    live = [sched.submit(p, SamplingParams(max_new_tokens=8), speculation=spec) for p in prompts]
    sched.step()
    errs = {"decode": check_decode_logits(graph, sched, "speculation"),
            "verify": check_verify_logits(graph, sched)}
    while not all(h.done() for h in live):
        sched.step()
    return {"prompt_lens": [len(p) for p in prompts], "k": spec.k, "plain": plain,
            "graph": runs["graph"], "eager": runs["eager"], "logits_max_abs_err": errs,
            "launches": runs["graph"]["launches"]}


def instrument_prefills(engine) -> dict:
    """Wrap ``engine.prefill_one``: per prefill step, its time by CUDA
    events around the step (the device is idle before it, as every step
    ends in a sync, so this is the step's span on the device, upload and
    readback included), and per suffix prefill (``prefix_len`` > 0) the
    paged launches it counted and (suffix bucket W, ms). Returns the
    record lists, which a caller empties between runs."""
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rec = {"prefill_ms": [], "suffix_launches": [], "suffix_ms": []}
    prefill_one = engine.prefill_one

    def timed(prompt, *a, prefix_len=0, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        launches = da.LAUNCHES["paged_append"]
        start.record()
        out = prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
        end.record()
        end.synchronize()
        rec["prefill_ms"].append(start.elapsed_time(end))
        if prefix_len > 0:
            rec["suffix_launches"].append(da.LAUNCHES["paged_append"] - launches)
            rec["suffix_ms"].append((engine.bucket_for(len(prompt) - prefix_len),
                                     rec["prefill_ms"][-1]))
        return out

    engine.prefill_one = timed
    return rec


def clear_prefix_cache(engine) -> None:
    """Start a run from an empty prefix cache and a full free list (no
    sequence may be running)."""
    engine.prefix_cache.reset()
    engine.allocator.reset()


def h2d_pinned_gb_per_s(nbytes: int = 64 << 20, reps: int = 5) -> float:
    """The host-to-device copy rate from pinned memory, by CUDA events."""
    import torch

    src = torch.empty((nbytes // 4,), dtype=torch.float32, pin_memory=True)
    dst = torch.empty_like(src, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return nbytes * reps / (start.elapsed_time(end) / 1e3) / 1e9


def prefix_cell_requests(rs, v: int):
    """The prefix cell's requests, drawn from ``rs``: 8 sharing one
    512-token system prompt (suffixes of 20-480 tokens, and one exact
    repeat) and a 64-token shared prefix with a 700-token suffix, 32 new
    tokens each (two of them seeded)."""
    from flexflow_tpu_torch.generation.engine import SamplingParams

    system = rs.randint(0, v, 512).tolist()
    prompts = [system + rs.randint(0, v, n).tolist() for n in (20, 40, 90, 150, 260, 300, 480)]
    prompts.append(list(system))  # fully covered: the boundary block is copied
    prompts.append(system[:64] + rs.randint(0, v, 700).tolist())  # suffix bucket 1024
    samplings = [SamplingParams(max_new_tokens=32)] * len(prompts)
    samplings[1] = SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234)
    samplings[7] = SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678)
    return prompts, samplings


def prefix_phase(seed: int, params) -> dict:
    """Cross-request prefix caching at GPT-2-small width behind the 4-slot
    engine: 8 requests sharing one 512-token system prompt (suffixes of
    20-480 tokens, and one exact repeat: the copy-on-write boundary),
    and a 64-token shared prefix with a 700-token suffix (the 1024 suffix
    bucket), 32 new tokens each. Engines with the cache on and off, on
    graph and on eager steps, each warmed (every step signature captured)
    and cleared before each run. Then the host tier: three 512-token
    prefixes cycled through an 80-block cache."""
    import numpy as np

    from flexflow_tpu_torch.generation.cache import CacheConfig
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    v, layers = cfg.vocab_size, cfg.num_layers
    rs = np.random.RandomState(seed + 8)
    prompts, samplings = prefix_cell_requests(rs, v)
    greedy = samplings[0]
    engines, recs = {}, {}
    wsys = rs.randint(0, v, 512).tolist()  # the warm-up's own system prompt
    warm_prompts = [wsys + rs.randint(0, v, n).tolist() for n in (9, 20, 40, 90, 150, 300)]
    warm_prompts[1:1] = [list(wsys)]
    warm_prompts.append(wsys[:64] + rs.randint(0, v, 700).tolist())
    for on in (True, False):
        for mode in ("graph", "eager"):
            engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16,
                                      prefix_cache=on, eager_steps=mode == "eager")
            warm(engine, rs)
            engine.generate(warm_prompts, SamplingParams(max_new_tokens=2))
            engines[on, mode] = engine
            recs[on, mode] = instrument_prefills(engine)
    runs, streams = {}, None
    for on, mode in ((True, "graph"), (False, "graph"), (False, "graph"), (True, "graph"),
                     (True, "eager"), (False, "eager")):
        engine, rec = engines[on, mode], recs[on, mode]
        clear_prefix_cache(engine)
        pc = engine.prefix_cache
        before = pc.snapshot()
        for v_ in rec.values():
            v_.clear()
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, _ = serve(engine, prompts, samplings)
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        stats["launches_by_window"] = {k: n for k, n in da.LAUNCHES_BY_WINDOW.items() if n}
        after = pc.snapshot()
        delta = {k: after[k] - before[k] for k in (
            "hits", "lookups", "tokens_reused_total", "blocks_reused_total", "cow_copies_total",
            "swaps_in_total", "swaps_out_total", "recompute_fallbacks")}
        n_suffix = len(rec["suffix_launches"])
        name = f"prefix {'on' if on else 'off'}, {mode} steps"
        outs = [h.result(0) for h in handles]
        if streams is None:
            streams = outs
        elif outs != streams:
            raise AssertionError(f"{name}: streams differ from the first run's")
        if any(n != layers for n in rec["suffix_launches"]):
            raise AssertionError(f"{name}: paged launches per suffix prefill "
                                 f"{rec['suffix_launches']}, expected {layers} each")
        want = layers * (stats["decode_steps"] + n_suffix)
        if launches["paged_append"] != want or launches["paged_append_split"]:
            raise AssertionError(f"{name}: launches {launches} != {layers} layers x "
                                 f"({stats['decode_steps']} decode steps + {n_suffix} suffix "
                                 "prefills)")
        if on and not (delta["hits"] > 0 and delta["tokens_reused_total"] > 0
                       and delta["cow_copies_total"] > 0 and n_suffix == delta["hits"]):
            raise AssertionError(f"{name}: prefix counters {delta}, {n_suffix} suffix prefills")
        if not on and (n_suffix or after["lookups"]):
            raise AssertionError(f"{name}: a disabled cache did prefix work: {after}")
        stats.update({
            "prefix": delta, "suffix_prefills": n_suffix,
            "paged_launches_per_suffix_prefill": sorted(set(rec["suffix_launches"])),
            "prefill_steps": len(rec["prefill_ms"]),
            "prefill_ms_per_request": float(np.mean(rec["prefill_ms"])),
            "prefill_ms_p50": float(np.median(rec["prefill_ms"])),
            "prefill_ms_total": float(np.sum(rec["prefill_ms"])),
            # device ms of a suffix prefill step, by its suffix bucket W
            "suffix_prefill_ms_by_bucket": {
                str(w): float(np.mean([ms for b, ms in rec["suffix_ms"] if b == w]))
                for w in sorted({b for b, _ in rec["suffix_ms"]})},
        })
        runs.setdefault(name, []).append(stats)
        print(f"{name}: " + json.dumps(stats))
    graph = engines[True, "graph"]
    captures = {k: n for k, n in graph.trace_counts.items() if k.startswith("prefix_prefill")}
    if not captures or any(n != 1 for n in captures.values()) or graph.recompiles():
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    # the host tier: three 512-token prefixes cycled through 80 usable
    # blocks (two prefixes and a live request fill it), so the coldest
    # prefix is offloaded to the host and swapped back in when it returns
    h2d = h2d_pinned_gb_per_s()
    small = GenerationEngine(
        params, cfg, cache_config=CacheConfig(num_layers=layers, num_heads=cfg.num_heads,
                                              head_dim=cfg.hidden_size // cfg.num_heads,
                                              num_blocks=81, block_size=16),
        max_batch_slots=4, block_size=16)
    off = engines[False, "graph"]
    clear_prefix_cache(off)
    prefixes = [rs.randint(0, v, 512).tolist() for _ in range(3)]
    tier_prompts = [p + rs.randint(0, v, 16).tolist() for _ in range(2) for p in prefixes]
    tier_sp = [greedy, samplings[1], greedy] * 2
    for prompt, sp in zip(tier_prompts, tier_sp):
        got = small.generate([prompt], sp)
        if got != off.generate([prompt], sp):
            raise AssertionError("host tier: a stream differs from the uncached engine's")
    tier = small.prefix_cache.snapshot()
    if not (tier["swaps_out_total"] > 0 and tier["swaps_in_total"] > 0):
        raise AssertionError(f"host tier: no offload and swap-in: {tier}")
    host = {k: tier[k] for k in ("swaps_out_total", "swaps_in_total", "recompute_fallbacks",
                                 "swap_in_failures", "hits", "tokens_reused_total",
                                 "offloaded_blocks", "host_bytes")}
    host.update(requests=len(tier_prompts), cache_blocks=80,
                host_link_bytes_per_s_model=small.prefix_cache.host_link_bytes_per_s,
                h2d_pinned_gb_per_s_measured=h2d)
    print("prefix host tier: " + json.dumps(host))
    return {"prompt_lens": [len(p) for p in prompts], "runs": runs,
            "captures": captures, "host_tier": host,
            "launches": runs["prefix on, graph steps"][0]["launches"],
            "cell": (prompts, samplings, streams)}


def check_pipelined_logits(engine, seed: int) -> float:
    """Drive a 4-slot scheduler with the overlap pipeline until a step is
    in flight whose tokens were carried on the device from its
    predecessor; once it completes, its logits (the graph's output, not
    yet overwritten) must agree with the plain attention path over the
    same inputs (the carried tokens as the host now knows them) within
    LOGITS_ATOL."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import decode_step
    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 6)
    sched = ContinuousBatchingScheduler(engine)
    handles = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(),
                            SamplingParams(max_new_tokens=12)) for n in (100, 37, 250, 16)]
    for _ in range(4):
        sched.step()
    f = sched._pipe
    if f is None or sched.pipe_dispatches < 2:
        raise AssertionError("overlap: no carried step in flight")
    torch.cuda.synchronize()
    got = f.handle.handle.extra  # this step's logits (+ its zero bias)
    tokens = np.zeros_like(f.positions)
    for s in f.states:
        tokens[s.slot] = s.req.generated[-1]  # the carried token, consumed since
    x = engine.decode_arrays(tokens, f.positions, f.tables, f.active)
    tok, pos, bt, ctx = (torch.from_numpy(x[k]).to(engine.device)
                         for k in ("tokens", "positions", "tables", "context_lens"))
    ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
    want, _, _ = decode_step(engine.params, tok, pos, ck, cv, bt, ctx, backend="plain")
    del ck, cv
    act = torch.from_numpy(f.active).to(engine.device)
    got, want = got[act], want[act]
    if not torch.isfinite(got).all():
        raise AssertionError("overlap: pipelined logits not finite")
    err = float((got - want).abs().max())
    print(f"overlap: a carried decode step's logits vs plain attention: max abs err "
          f"{err:.3e} ({int(act.sum())} live slots)")
    if err > LOGITS_ATOL:
        raise AssertionError(f"overlap: pipelined logits differ by {err} > {LOGITS_ATOL}")
    while not all(h.done() for h in handles):
        sched.step()
    torch.cuda.empty_cache()
    return err


@contextlib.contextmanager
def plain_attention():
    """The decoder's paged attention through the plain PyTorch version (no
    kernel launch) while the block runs. For an eager engine only: a
    graph captured inside would hold the plain version's ops."""
    from flexflow_tpu_torch.generation import decoder

    saved = decoder.decode_attention_core, decoder.append_attention_core

    def plain(core):
        return lambda *a, **kw: core(*a, **{**kw, "backend": "plain"})

    decoder.decode_attention_core, decoder.append_attention_core = map(plain, saved)
    try:
        yield
    finally:
        decoder.decode_attention_core, decoder.append_attention_core = saved


def launched_only(expected: dict) -> dict:
    """The launch counts since the last reset: each form named in
    ``expected`` launched exactly that many times (at least once), every
    other form none."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    got = dict(da.LAUNCHES)
    want = {name: expected.get(name, 0) for name in got}
    if got != want or not all(expected.values()):
        raise AssertionError(f"launches {got}, expected {want}")
    return got


def kv_dtype_phase(seed: int, params, cell, fp32_engine) -> dict:
    """Serving from a 2-byte KV cache at GPT-2-small width: a bf16 cache of
    257 blocks of 16 (the serving cell's blocks, half its bytes) behind
    graph and eager 4-slot engines, then a shorter fp16 run. Returns the
    phase's numbers and the main-path launches of each 2-byte form."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.cache import CacheConfig
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    layers, v = cfg.num_layers, cfg.vocab_size
    prompts, samplings, fp32_streams = cell
    rs = np.random.RandomState(seed + 12)
    spec = SpeculationConfig(k=4)
    launches = {f"paged_append{split}{form}": 0
                for form in ("_bf16", "_f16") for split in ("", "_split")}

    def cache(dtype, num_blocks=257):
        return CacheConfig(num_layers=layers, num_heads=cfg.num_heads,
                           head_dim=cfg.hidden_size // cfg.num_heads,
                           num_blocks=num_blocks, block_size=16, dtype=dtype)

    def steps(engine, kinds=("decode",)):
        return sum(engine.step_counts[k] for k in kinds)

    def paged_calls(engine):
        """Decode and verify steps, and (a graph engine) the warm-up run
        before each capture of a step that launches the paged kernel:
        one launch a layer each."""
        captures = sum(n for k, n in engine.trace_counts.items()
                       if k in ("decode", "verify") or k.startswith("prefix_prefill"))
        return steps(engine, ("decode", "verify")) + (captures if engine.graphs else 0)

    by_window = {name: 0 for name in da.LAUNCHES_BY_WINDOW
                 if name.split(" ")[0] in launches}

    def main_path(run, expected):
        """``run()`` with the counts set to 0 just before and read just
        after: only ``expected(...)``'s forms launched."""
        da.reset_launch_counts()
        result = run()
        for name, n in launched_only(expected()).items():
            if name in launches:
                launches[name] += n
        for name in by_window:
            by_window[name] += da.LAUNCHES_BY_WINDOW[name]
        return result

    def seg_prompts(n):
        out = []
        for seg_len, reps in ((24, 4), (40, 3), (16, 6), (60, 2))[:n]:
            seg = rs.randint(0, v, seg_len).tolist()
            out.append(seg * reps + seg[:6])
        return out

    def speculate(engine, name, form, new_tokens):
        """Greedy, then k = 4 n-gram speculation over the same requests:
        equal streams, kernel launches per decode and verify step, and a
        live speculating batch's decode and verify logits vs plain
        attention."""
        sp_prompts = seg_prompts(4)
        greedy = [SamplingParams(max_new_tokens=new_tokens)] * len(sp_prompts)
        p0 = paged_calls(engine)
        handles = main_path(lambda: serve(engine, sp_prompts, greedy)[0],
                            lambda: {"paged_append" + form: layers * (paged_calls(engine) - p0)})
        plain = [h.result(0) for h in handles]
        p0, v0, vs0 = paged_calls(engine), steps(engine, ("verify",)), engine.step_seconds["verify"]
        handles = main_path(
            lambda: serve(engine, sp_prompts, greedy, speculation=spec)[0],
            lambda: {"paged_append" + form: layers * (paged_calls(engine) - p0)})
        vsteps = steps(engine, ("verify",)) - v0
        if [h.result(0) for h in handles] != plain or vsteps == 0:
            raise AssertionError(f"{name}: speculative greedy streams differ from plain ones "
                                 f"({vsteps} verify steps)")
        sched = ContinuousBatchingScheduler(engine)
        live = [sched.submit(p, SamplingParams(max_new_tokens=8), speculation=spec)
                for p in sp_prompts]
        sched.step()
        errs = {"decode": check_decode_logits(engine, sched, f"{name} speculation"),
                "verify": check_verify_logits(engine, sched)}
        while not all(h.done() for h in live):
            sched.step()
        return {"verify_steps": vsteps,
                "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vs0) / vsteps,
                "logits_max_abs_err": errs}

    def long_context(dtype, name, form, new_tokens):
        """One ~900-token stream in a 1-slot engine: the split-KV kernel of
        the cache's form, num_layers launches a decode step, and a decode
        step's logits vs plain attention."""
        cc = CacheConfig.for_slots(num_layers=layers, num_heads=cfg.num_heads,
                                   head_dim=cfg.hidden_size // cfg.num_heads,
                                   max_seq_len=cfg.seq_length, max_batch_slots=1,
                                   block_size=16, dtype=dtype)
        engine = GenerationEngine(params, cfg, cache_config=cc, max_batch_slots=1,
                                  prefix_cache=False)
        prompt = rs.randint(0, v, 900).tolist()
        p0 = paged_calls(engine)
        main_path(lambda: serve(engine, [prompt], [SamplingParams(max_new_tokens=new_tokens)]),
                  lambda: {"paged_append_split" + form: layers * (paged_calls(engine) - p0)})
        sched = ContinuousBatchingScheduler(engine)
        h = sched.submit(rs.randint(0, v, 880).tolist(), SamplingParams(max_new_tokens=4))
        sched.step()
        err = check_decode_logits(engine, sched, f"{name} long context")
        while not h.done():
            sched.step()
        return {"prompt_len": len(prompt), "logits_max_abs_err": err}

    out = {}
    # the bf16 cell: graph and eager engines, each from a zeroed cache
    engines = engine_pair(params, cache_config=cache(DataType.BFLOAT16), max_batch_slots=4,
                          max_spec_tokens=4)
    graph, eager = engines["graph"], engines["eager"]
    if (graph.cache.k.dtype != torch.bfloat16
            or 2 * graph.cache.k.nbytes != fp32_engine.cache.k.nbytes):
        raise AssertionError(f"bf16 cache {graph.cache.k.dtype}, {graph.cache.k.nbytes} bytes "
                             f"against the fp32 cell's {fp32_engine.cache.k.nbytes}")
    warm(graph, rs)
    warm(graph, rs, speculation=spec)
    runs, streams = {}, {}
    for name, engine in (("graph", graph), ("eager", eager)):
        engine.reset()
        d0, p0, dsec0 = steps(engine), paged_calls(engine), engine.step_seconds["decode"]
        handles, wall, ttft, _ = main_path(
            lambda: serve(engine, prompts, samplings),
            lambda: {"paged_append_bf16": layers * (paged_calls(engine) - p0)})
        runs[name] = run_stats(engine, handles, wall, ttft, d0, dsec0, dict(da.LAUNCHES))
        streams[name] = [h.result(0) for h in handles]
        print(f"kv dtype bf16 (4 slots, {name} steps): " + json.dumps(runs[name]))
    if streams["graph"] != streams["eager"]:
        raise AssertionError("bf16 cache: graph and eager streams differ")
    for t in ("k", "v"):  # past scratch block 0, where colliding padding writes land in any order
        if not torch.equal(getattr(graph.cache, t)[:, 1:], getattr(eager.cache, t)[:, 1:]):
            raise AssertionError(f"bf16 cache: graph replays and eager steps wrote different {t}")
    if not torch.equal(graph.last_logits, eager.last_logits):
        raise AssertionError("bf16 cache: the last step's logits differ, graph vs eager")
    # the same requests with plain attention over the same cache dtype
    eager.reset()
    with plain_attention():
        da.reset_launch_counts()
        handles = serve(eager, prompts, samplings)[0]
        if any(da.LAUNCHES.values()):
            raise AssertionError(f"plain attention launched kernels: {da.LAUNCHES}")
    plain = [h.result(0) for h in handles]
    greedy = [i for i, sp in enumerate(samplings) if sp.temperature <= 0]
    if [plain[i] for i in greedy] != [streams["graph"][i] for i in greedy]:
        raise AssertionError("bf16 cache: greedy streams differ from plain attention's")
    tokens = sum(len(s) for s in fp32_streams)
    out.update({
        "cache_bytes": 2 * graph.cache.k.nbytes,
        "fp32_cache_bytes": 2 * fp32_engine.cache.k.nbytes,
        "runs": runs,
        "tokens_equal_to_plain_attention": sum(
            a == b for x, y in zip(plain, streams["graph"]) for a, b in zip(x, y)),
        "tokens_equal_to_fp32_cache": sum(
            a == b for x, y in zip(fp32_streams, streams["graph"]) for a, b in zip(x, y)),
        "tokens": tokens,
    })
    sched = ContinuousBatchingScheduler(graph)
    extra = [sched.submit(rs.randint(0, v, n).tolist(), SamplingParams(max_new_tokens=4))
             for n in (100, 37, 250, 16)]
    sched.step()
    out["logits_max_abs_err"] = check_decode_logits(graph, sched, "kv dtype bf16")
    while not all(h.done() for h in extra):
        sched.step()
    # a 4-slot decode step's device time, its graph replayed back to back:
    # the fp32 cell's engine and the bf16 one in turns
    order = (("fp32", fp32_engine), ("bf16", graph), ("bf16", graph), ("fp32", fp32_engine))
    device_ms = {"fp32": [], "bf16": []}
    for label, engine in order:
        device_ms[label].append(decode_graph_device_ms(engine))
    out["decode_step_device_ms"] = device_ms
    out["speculation"] = speculate(graph, "kv dtype bf16", "_bf16", 24)
    out["long_context"] = long_context(DataType.BFLOAT16, "kv dtype bf16", "_bf16", 16)
    # the host tier over a bf16 cache: the prefix cell's three 512-token
    # prefixes cycled twice through 80 blocks, streams equal to the
    # uncached bf16 engine's
    small = GenerationEngine(params, cfg, cache_config=cache(DataType.BFLOAT16, 81),
                             max_batch_slots=4)
    prefixes = [rs.randint(0, v, 512).tolist() for _ in range(3)]
    tier_prompts = [p + rs.randint(0, v, 16).tolist() for _ in range(2) for p in prefixes]
    tier_sp = [SamplingParams(max_new_tokens=32), samplings[-1],
               SamplingParams(max_new_tokens=32)] * 2
    before = small.prefix_cache.snapshot()
    s0, g0 = paged_calls(small), paged_calls(graph)

    def tier():
        for prompt, sp in zip(tier_prompts, tier_sp):
            if small.generate([prompt], sp) != graph.generate([prompt], sp):
                raise AssertionError("bf16 host tier: a stream differs from the uncached engine's")

    hits = lambda: small.prefix_cache.snapshot()["hits"] - before["hits"]  # noqa: E731
    main_path(tier, lambda: {"paged_append_bf16": layers * (
        paged_calls(small) - s0 + paged_calls(graph) - g0 + hits())})
    snap = small.prefix_cache.snapshot()
    host = {k: snap[k] - before[k] for k in ("swaps_out_total", "swaps_in_total",
                                              "recompute_fallbacks", "hits")}
    if not (host["swaps_out_total"] > 0 and host["swaps_in_total"] > 0):
        raise AssertionError(f"bf16 host tier: no offload and swap-in: {host}")
    host["host_bytes_per_block"] = small.cache_config.bytes_per_block
    out["host_tier"] = host
    print("kv dtype bf16 host tier: " + json.dumps(host))
    del engines, graph, eager, small, sched
    torch.cuda.empty_cache()
    # fp16: a shorter run, decode and verify steps, and a long context
    half = GenerationEngine(params, cfg, cache_config=cache(DataType.HALF), max_batch_slots=4,
                            max_spec_tokens=4, prefix_cache=False)
    out["fp16"] = {"speculation": speculate(half, "kv dtype fp16", "_f16", 16),
                   "long_context": long_context(DataType.HALF, "kv dtype fp16", "_f16", 8)}
    del half
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["launches_by_window"] = by_window
    print("kv dtype: " + json.dumps(out))
    return out


def card_clocks() -> str:
    """The card's SM clock and power draw now (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class LaunchTimer:
    """CUDA events around every launch of an engine's decode step while
    it is entered: around each replay of the captured decode graph (graph
    steps) or each run of the decode body (eager steps). ``seconds()``
    sums the stream's time from each opening event to its closing one."""

    def __init__(self, engine):
        self.engine, self.marks = engine, []

    def _timed(self, fn):
        import torch

        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.marks.append((start, end))
            return out
        return launch

    def __enter__(self):
        engine = self.engine
        if engine.graphs:
            self.step = engine._steps._steps[
                ("decode", (engine.max_batch_slots, engine.max_blocks_per_seq))]
            self.graph = self.step.graph
            timed = self._timed(self.graph.replay)
            self.step.graph = type("TimedGraph", (), {"replay": staticmethod(timed)})()
        else:
            engine._decode_body = self._timed(engine._decode_body)
        return self

    def __exit__(self, *exc):
        if self.engine.graphs:
            self.step.graph = self.graph
        else:
            del self.engine._decode_body  # back to the class's method
        return False

    def seconds(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.marks) / 1e3


def steady_stretch(engine, prompts, overlap: bool, steps: int, device_of=None,
                   sched=None) -> dict:
    """Four slots decoding ``steps`` steps with nothing non-steady in
    between (admitted before, finishing after): host-clock ms per step,
    the engine's dispatch / execute / readback split of it
    (``phase_time_s["decode"]``), the stream's time per step (CUDA events around
    each launch, :class:`LaunchTimer`: from the stream reaching the step
    to its end, which is the step's device time when the step was queued
    behind its predecessor, and adds the launch's latency when the stream
    was idle), the card's SM clock and power just after the window, and
    the device's busy share: a decode step's device time (``device_of``
    (engine), or the engine's own graph replayed back to back right after
    the window, on the last step's inputs) over the ms per step. ``sched``
    replaces the scheduler (durability attached, journeys off)."""
    import torch

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    if sched is None:
        sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    handles = [sched.submit(p, SamplingParams(max_new_tokens=steps + 8)) for p in prompts]
    sched.step()  # the admissions and one sequential decode step
    sched.step()  # with overlap: the pipeline's first dispatch
    torch.cuda.synchronize()
    decode0, drains0 = engine.step_counts["decode"], dict(sched.pipe_drains)
    phases0 = dict(engine.phase_time_s["decode"])
    with LaunchTimer(engine) as timer:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = timer.seconds()
    n = engine.step_counts["decode"] - decode0
    if n != steps or sched.pipe_drains != drains0 or len(sched._running) != len(prompts):
        raise AssertionError(f"steady stretch not steady: {n} steps, drains {sched.pipe_drains}")
    if len(timer.marks) != n:
        raise AssertionError(f"steady stretch: {len(timer.marks)} timed launches, {n} steps")
    # the window's steps were dispatched and consumed inside it, but for
    # the pipeline's in-flight step at each end: n steps' worth either way
    phases = {f"{k}_ms_per_step": 1e3 * (engine.phase_time_s["decode"][k] - phases0[k]) / n
              for k in phases0}
    clocks = card_clocks()
    # a replay on the last step's inputs recomputes its outputs bit for
    # bit, so the in-flight step's readback and token carry are unchanged
    device_ms = (device_of or decode_graph_device_ms)(engine)
    while not all(h.done() for h in handles):
        sched.step()
    ms = 1e3 * wall / n
    return {"steps": n, "ms_per_step": ms, **phases,
            "stream_ms_per_step": 1e3 * device / n,
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / ms,
            "clocks_sm_power": clocks}


def decode_graph_device_ms(engine, reps: int = 20) -> float:
    """The device time of one 4-slot decode step: its captured graph
    replayed ``reps`` times back to back between CUDA events, on the last
    step's inputs (each replay rewrites the same K/V, in blocks no live
    request holds; the launch counters are not touched)."""
    import torch

    step = engine._steps._steps[("decode", (engine.max_batch_slots, engine.max_blocks_per_seq))]
    torch.cuda.synchronize()
    step.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def overlap_recovery(engine, prompts, samplings, streams) -> dict:
    """The overlap pipeline's failures on the card, each through a fresh
    scheduler over the cell's requests: a decode-step crash and an
    async-readback error (``donate`` is set on the card, so each resets
    the engine and replays the journal) and a NaN on one slot
    (quarantine). Surviving streams must equal the fault-free ones, the
    cache tensors must stay where the graphs hold them, and nothing may
    be captured again."""
    import numpy as np

    from flexflow_tpu_torch.generation.recovery import PoisonedRequestError
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.runtime import faults

    if not engine.donate:
        raise AssertionError("a CUDA engine must default to donate=True")
    cases = {
        "decode_step crash": (faults.FaultPlan(seed=0).on(
            faults.GENERATION_DECODE_STEP, mode="error",
            error=RuntimeError("injected device crash"), nth=(12,)), 1, 0),
        "async_readback error": (faults.FaultPlan(seed=0).on(
            faults.GENERATION_ASYNC_READBACK, mode="error",
            error=faults.FaultInjected("injected readback loss"), nth=(6,)), 1, 0),
        "NaN on slot 1": (faults.FaultPlan(seed=0).on(
            faults.GENERATION_DECODE_STEP, mode="nan", nth=(10,),
            select=lambda v: np.asarray([False, True, False, False])), 0, 1),
    }
    out = {}
    for name, (plan, want_resets, want_failed) in cases.items():
        ptrs = (engine.cache.k.data_ptr(), engine.cache.v.data_ptr())
        captures, resets0 = dict(engine.trace_counts), engine.resets
        sched = ContinuousBatchingScheduler(engine)
        with plan.active():
            handles = [sched.submit(p, s) for p, s in zip(prompts, samplings)]
            while not all(h.done() for h in handles):
                sched.step()
        failed, survivors = 0, []
        for h, ref in zip(handles, streams):
            try:
                got = h.result(0)
            except PoisonedRequestError:
                failed += 1
                continue
            survivors.append(got == ref)
        resets = engine.resets - resets0
        rec = {"fired": len(plan.events), "resets": resets,
               "failed": failed, "recovery": sched.recovery_stats.snapshot(),
               "pipe_discards": sched.pipe_discards, "pipe_drains": dict(sched.pipe_drains)}
        print(f"overlap recovery, {name}: " + json.dumps(rec))
        if rec["fired"] != 1 or resets != want_resets or failed != want_failed:
            raise AssertionError(f"{name}: {rec}, expected {want_resets} resets and "
                                 f"{want_failed} quarantined")
        if not all(survivors):
            raise AssertionError(f"{name}: a surviving stream differs from the fault-free run")
        if (engine.cache.k.data_ptr(), engine.cache.v.data_ptr()) != ptrs:
            raise AssertionError(f"{name}: the KV cache moved")
        if engine.trace_counts != captures:
            raise AssertionError(f"{name}: captured again: {engine.trace_counts} vs {captures}")
        out[name] = rec
    return out


def overlap_phase(seed: int, params) -> dict:
    """The overlap pipeline on the 4-slot serving cell (the serving
    phase's 8 request lengths and samplings), graph steps with the
    pipeline on and off in the order on, off, off, on after a warm-up:
    streams identical across all four runs and to the eager engine's
    sequential run, the pipeline engaged, one capture per signature, 12
    paged launches per decode step; a carried step's logits against the
    plain attention path; the steady stretch (4 slots x 128 steps, and
    32 on eager steps) on and off; then the recovery cases."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=4, block_size=16)
    graph, eager = engines["graph"], engines["eager"]
    rs = np.random.RandomState(seed + 5)
    for engine in engines.values():
        warm(engine, rs)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 6 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    handles, _, _, _ = serve(eager, prompts, samplings, overlap=False)
    streams = [h.result(0) for h in handles]
    runs = {"on": [], "off": []}
    launches = 0
    for mode in ("on", "off", "off", "on"):
        decode0, dsec0 = graph.step_counts["decode"], graph.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, sched = serve(graph, prompts, samplings, overlap=mode == "on")
        stats = run_stats(graph, handles, wall, ttft, decode0, dsec0, dict(da.LAUNCHES))
        stats.update(pipe_dispatches=sched.pipe_dispatches, pipe_drains=dict(sched.pipe_drains),
                     pipe_discards=sched.pipe_discards)
        if [h.result(0) for h in handles] != streams:
            raise AssertionError(f"overlap {mode}: streams differ from the eager sequential run")
        steps = stats["decode_steps"]
        if stats["launches"]["paged_append"] != cfg.num_layers * steps:
            raise AssertionError(f"overlap {mode}: launches {stats['launches']} != "
                                 f"{cfg.num_layers} x {steps} decode steps")
        if mode == "on" and (sched.pipe_dispatches == 0 or sched.pipe_discards):
            raise AssertionError(f"overlap on: {stats}")
        launches += stats["launches"]["paged_append"]
        runs[mode].append(stats)
        print(f"overlap {mode} (4 slots, graph steps): " + json.dumps(stats))
    if graph.trace_counts.get("decode") != 1 or graph.recompiles():
        raise AssertionError(f"overlap: graph engine signatures {graph.trace_counts}")
    stats = {"runs": runs, "launches": {"paged_append": launches},
             "captures": dict(graph.trace_counts)}
    stats["logits_max_abs_err"] = check_pipelined_logits(graph, seed)
    four = [rs.randint(0, cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    # an eager step runs the graph's kernels: its device time is the graph
    # engine's, replayed back to back just after the eager window
    for name, engine, steps, device_of in (
            ("graph", graph, 128, None),
            ("eager", eager, 32, lambda _engine: decode_graph_device_ms(graph))):
        for mode in ("on", "off", "off", "on"):
            r = steady_stretch(engine, four, mode == "on", steps, device_of)
            stats.setdefault(f"steady_{name}", {}).setdefault(mode, []).append(r)
            print(f"overlap steady stretch ({name} steps, overlap {mode}): " + json.dumps(r))
    stats["recovery"] = overlap_recovery(graph, prompts, samplings, streams)
    return stats


# a grammar per constrained request of the constrained phase: a JSON
# object and a regex (the first two formats), and one that never ends,
# for the timed stretch with a constrained slot
CONSTRAINED_SCHEMA = {"type": "object",
                      "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}}
CONSTRAINED_FORMATS = (
    {"type": "json_schema", "json_schema": CONSTRAINED_SCHEMA},
    {"type": "regex", "pattern": "[a-z]{1,8}-[0-9]{2,4}"},
    {"type": "regex", "pattern": "[a-z ]+"},
)


def serving_vocabulary(size: int) -> tuple:
    """A deterministic token table of exactly ``size`` entries: the port's
    default table (which stops at 1422 entries), then three-character
    fillers over its filler alphabet."""
    from flexflow_tpu_torch.generation.constrained import default_vocabulary

    toks = list(default_vocabulary(size))
    fill = ("".join(p) for p in itertools.product("0123456789abcdefghijklmnopqrstuvwxyz_",
                                                   repeat=3))
    toks.extend(itertools.islice(fill, size - len(toks)))
    if len(toks) != size:
        raise AssertionError(f"vocabulary of {len(toks)} entries, wanted {size}")
    return tuple(toks)


def check_grammar_text(vocab, tokens, spec) -> str:
    """The stream's text, which must be what its grammar allows."""
    from flexflow_tpu_torch.generation.constrained import (
        compile_regex,
        decode_text,
        grammar_alphabet,
        validate_json,
    )

    text = decode_text(vocab, tokens, None)
    if spec["type"] == "json_schema":
        errs = validate_json(text, spec["json_schema"])
        if errs:
            raise AssertionError(f"constrained: {text!r} fails its schema: {errs}")
    elif not compile_regex(spec["pattern"], grammar_alphabet(vocab)).matches(text):
        raise AssertionError(f"constrained: {text!r} does not match {spec['pattern']!r}")
    return text


def serve_grammars(engine, prompts, samplings, grammars, overlap=None, speculation=None):
    """Every request at once through a fresh scheduler (a grammar per
    request, None for an unconstrained one; ``speculation`` for the greedy
    requests), stepped to the end. Returns (handles, scheduler, wall s)."""
    import torch

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    t0 = time.perf_counter()
    handles = [sched.submit(p, s, grammar=g,
                            speculation=speculation if s.temperature <= 0 else None)
               for p, s, g in zip(prompts, samplings, grammars)]
    for _ in range(10_000):
        if all(h.done() for h in handles):
            break
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(h.done() for h in handles):
        raise AssertionError("constrained: requests did not finish")
    return handles, sched, wall


def check_masked_logits(engine, grammars, rs) -> dict:
    """A live constrained batch (two constrained greedy slots with the
    n-gram drafter, two unconstrained): one masked decode step and one
    masked verify step (legal drafts walked along each grammar) run
    through the engine's graphs, whose logits must agree with the plain
    attention path's plus the same grammar rows within LOGITS_ATOL."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import decode_step, verify_step
    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig

    cfg, dev = engine.cfg, engine.device
    b, w, v = engine.max_batch_slots, engine.spec_window, cfg.vocab_size
    sched = ContinuousBatchingScheduler(engine, overlap=False)
    spec = SpeculationConfig(k=w - 1)
    live = [sched.submit(rs.randint(0, v, n).tolist(), SamplingParams(max_new_tokens=24),
                         grammar=g, speculation=spec if g is not None else None)
            for n, g in zip((100, 37, 250, 16), (grammars[0], grammars[1], None, None))]
    sched.step()  # admissions + one masked verify (zero or more drafts)
    order = sorted(sched._running.values(), key=lambda s: s.slot)
    slots = sched._collect_slots(order)
    tokens, positions, tables, active = slots[:4]
    mask = sched._decode_mask(order)
    dense = np.zeros((b, v), np.float32)
    for i, row in mask.items():
        dense[i] = row
    engine.decode(*slots, mask=mask)
    got = engine.last_logits.clone()
    x = engine.decode_arrays(tokens, positions, tables, active)
    ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
    want, _, _ = decode_step(engine.params, *(torch.from_numpy(x[k]).to(dev) for k in (
        "tokens", "positions")), ck, cv, torch.from_numpy(x["tables"]).to(dev),
        torch.from_numpy(x["context_lens"]).to(dev), backend="plain")
    del ck, cv
    act = torch.from_numpy(active).to(dev)
    want = want + torch.from_numpy(dense).to(dev)
    errs = {"decode": float((got[act] - want[act]).abs().max())}
    if not torch.isfinite(got[act]).all():
        raise AssertionError("constrained: masked decode logits not finite")
    # a masked verify step: each constrained slot drafts a legal walk
    sched._plan_speculation()
    sched._grow()
    order = sorted(sched._running.values(), key=lambda s: s.slot)
    last, start, tables, _, temps, top_ks, seeds, counts = sched._collect_slots(order)
    window = np.zeros((b, w), np.int32)
    window[:, 0] = last
    n_draft = np.full((b,), -1, np.int32)
    bs = engine.cache_config.block_size
    for state in order:
        room = min(w - 1, len(state.blocks) * bs - state.cached_len - 1)
        ms, draft = state.req.mask_state, []
        if ms is not None:
            st = ms.state
            while len(draft) < room and ms.dfa.allowed(st):
                tok = int(ms.dfa.allowed(st)[rs.randint(len(ms.dfa.allowed(st)))])
                draft.append(tok)
                st = ms.dfa.step(st, tok)
        window[state.slot, 1: 1 + len(draft)] = draft
        n_draft[state.slot] = len(draft)
    wmask = sched._verify_mask(order, window, n_draft)
    dense = np.zeros((b, w, v), np.float32)
    for (i, j), row in wmask.items():
        dense[i, j] = row
    engine.verify(window, start, n_draft, tables, temps, top_ks, seeds, counts, wmask)
    got = engine.last_logits.clone()
    offs = np.arange(w)[None, :]
    pos = np.where(offs <= n_draft[:, None], start[:, None] + offs, -1).astype(np.int32)
    ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
    want, _, _ = verify_step(engine.params, torch.from_numpy(window).to(dev),
                             torch.from_numpy(pos).to(dev), ck, cv,
                             torch.from_numpy(tables).to(dev), backend="plain")
    del ck, cv
    valid = torch.from_numpy(pos >= 0).to(dev)
    want = want + torch.from_numpy(dense).to(dev)
    if not torch.isfinite(got[valid]).all():
        raise AssertionError("constrained: masked verify logits not finite")
    errs["verify"] = float((got[valid] - want[valid]).abs().max())
    errs["verify_drafts"] = n_draft.tolist()
    print("constrained: masked logits kernel vs plain attention: max abs err "
          + json.dumps(errs))
    if max(errs["decode"], errs["verify"]) > LOGITS_ATOL:
        raise AssertionError(f"constrained: masked logits differ: {errs}")
    for h in live:
        h.cancel()
    sched.step()
    torch.cuda.empty_cache()
    return errs


def constrained_stretch(engine, prompts, grammars, overlap: bool, steps: int) -> dict:
    """Four slots decoding ``steps`` greedy steps with nothing non-steady
    but the grammar (admitted before, finishing after): host-clock ms per
    step, the engine's dispatch / execute / readback split of it (the
    mask rows are written inside the dispatch), the grammar-mask bytes
    written per step and the steps that wrote any."""
    import torch

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    handles = [sched.submit(p, SamplingParams(max_new_tokens=steps + 8), grammar=g)
               for p, g in zip(prompts, grammars)]
    sched.step()
    sched.step()
    torch.cuda.synchronize()
    decode0, bytes0, masked0 = (engine.step_counts["decode"], engine.mask_bytes_staged,
                                engine.masked_step_count)
    phases0 = dict(engine.phase_time_s["decode"])
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = engine.step_counts["decode"] - decode0
    if n != steps or len(sched._running) != len(prompts):
        raise AssertionError(f"constrained stretch not steady: {n} steps")
    out = {"steps": n, "ms_per_step": 1e3 * wall / n,
           **{f"{k}_ms_per_step": 1e3 * (engine.phase_time_s["decode"][k] - phases0[k]) / n
              for k in phases0},
           "mask_bytes_per_step": (engine.mask_bytes_staged - bytes0) / n,
           "masked_steps": engine.masked_step_count - masked0}
    while not all(h.done() for h in handles):
        sched.step()
    return out


def constrained_phase(seed: int, params) -> dict:
    """Constrained decoding at GPT-2-small width behind the 4-slot engine:
    a 50257-entry vocabulary, a JSON-schema and a regex grammar, and the
    serving cell's 8 request lengths (prompts that are prefixes of one
    another, so with the prefix cache on the constrained admissions are
    masked suffix prefills): 4 constrained (2 greedy, 2 at temperature
    0.8 / top-k 50) and 4 unconstrained greedy, 32 new tokens each.
    Every engine first serves the same requests unconstrained, which
    captures every signature the constrained runs use."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.constrained import GrammarCache
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.recovery import PoisonedRequestError
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.serving.stats import ConstrainedStats

    cfg = gpt2_small()
    vocab = serving_vocabulary(cfg.vocab_size)
    cstats = ConstrainedStats()
    cache = GrammarCache(vocab, stats=cstats)
    compile_s, grammars = [], []
    for spec in CONSTRAINED_FORMATS:
        t0 = time.perf_counter()
        grammars.append(cache.get(spec))
        compile_s.append(time.perf_counter() - t0)
    states = [g.char_dfa.n_states for g in grammars]
    print(f"constrained: grammars of {states} character states compiled in "
          + ", ".join(f"{s:.3f}" for s in compile_s) + " s; the start states allow "
          + ", ".join(str(len(g.allowed(g.start))) for g in grammars) + " tokens")
    engines = engine_pair(params, max_batch_slots=4, block_size=16, max_spec_tokens=4)
    engines["prefix"] = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16,
                                         max_spec_tokens=4, prefix_cache=True)
    spec = SpeculationConfig(k=4)
    rs = np.random.RandomState(seed + 9)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    base = rs.randint(0, cfg.vocab_size, max(lens)).tolist()
    prompts = [base[:n] for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 2 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ] + [SamplingParams(max_new_tokens=32)] * 4
    formats = list(CONSTRAINED_FORMATS[:2]) * 2 + [None] * 4
    request_grammars = [None if f is None else grammars[CONSTRAINED_FORMATS.index(f)]
                        for f in formats]
    captures = {}
    for name, engine in engines.items():
        warm(engine, rs)
        warm(engine, rs, speculation=spec)
        if name == "prefix":
            clear_prefix_cache(engine)
        serve_grammars(engine, prompts, samplings, [None] * 8)
        serve_grammars(engine, prompts, samplings, [None] * 8, speculation=spec)
        captures[name] = dict(engine.trace_counts)
    runs, streams = {}, None
    for label, name, overlap, speculation in (
            ("graph, overlap on", "graph", True, None),
            ("eager, overlap off", "eager", False, None),
            ("graph, overlap off", "graph", False, None),
            ("graph, speculation k=4", "graph", True, spec),
            ("prefix on, graph", "prefix", True, None),
            ("graph, overlap on (again)", "graph", True, None)):
        engine = engines[name]
        if name == "prefix":
            clear_prefix_cache(engine)
        steps0 = dict(engine.step_counts)
        hits0 = engine.prefix_cache.hits
        vsec0 = engine.step_seconds["verify"]
        da.reset_launch_counts()
        handles, sched, wall = serve_grammars(engine, prompts, samplings, request_grammars,
                                              overlap=overlap, speculation=speculation)
        launches = dict(da.LAUNCHES)
        outs = [h.result(0) for h in handles]
        texts = [check_grammar_text(vocab, out, f) for out, f in zip(outs, formats)
                 if f is not None]
        decode = engine.step_counts["decode"] - steps0["decode"]
        verify = engine.step_counts["verify"] - steps0["verify"]
        suffix = engine.prefix_cache.hits - hits0
        want = cfg.num_layers * (decode + verify + suffix)
        if launches["paged_append"] != want or launches["paged_append_split"]:
            raise AssertionError(f"constrained {label}: launches {launches} != "
                                 f"{cfg.num_layers} x ({decode} decode + {verify} verify + "
                                 f"{suffix} suffix prefill steps)")
        greedy = [o for o, s in zip(outs, samplings) if s.temperature <= 0]
        if streams is None:
            streams = outs
        elif (greedy if speculation else outs) != (
                [o for o, s in zip(streams, samplings) if s.temperature <= 0]
                if speculation else streams):
            raise AssertionError(f"constrained {label}: streams differ from the first run's")
        if name == "prefix" and suffix == 0:
            raise AssertionError("constrained: the prefix cache served no suffix prefill")
        runs[label] = {"decode_steps": decode, "verify_steps": verify,
                       "suffix_prefills": suffix, "wall_s": wall, "launches": launches,
                       "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vsec0)
                       / max(verify, 1),
                       "masked_steps": sched.constrained_stats.masked_steps,
                       "pipe_dispatches": sched.pipe_dispatches}
        print(f"constrained ({label}): " + json.dumps(runs[label]) + " texts "
              + json.dumps(texts))
    for name, engine in engines.items():
        if engine.trace_counts != captures[name]:
            raise AssertionError(f"constrained traffic captured on {name}: "
                                 f"{engine.trace_counts} vs {captures[name]}")
    graph = engines["graph"]
    stats = {"compile_s": compile_s, "char_states": states, "runs": runs,
             "launches": {"paged_append": sum(r["launches"]["paged_append"]
                                              for r in runs.values())}}
    stats["logits_max_abs_err"] = check_masked_logits(graph, grammars, rs)
    # the timed stretch: 4 live slots, none / one constrained, sequential
    # and pipelined (a constrained slot always steps sequentially)
    four = [rs.randint(0, cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    open_g = grammars[2]
    cases = {"unconstrained, overlap off": ([None] * 4, False),
             "one constrained slot": ([open_g, None, None, None], True),
             "unconstrained, overlap on": ([None] * 4, True)}
    stretch = {}
    for label in list(cases) + list(reversed(cases)):
        gs, overlap = cases[label]
        r = constrained_stretch(graph, four, gs, overlap, 64)
        stretch.setdefault(label, []).append(r)
        print(f"constrained stretch ({label}, graph steps): " + json.dumps(r))
    stats["stretch"] = stretch
    # a mask_advance error quarantines one constrained request
    plan = faults.FaultPlan(seed=0).on(faults.GENERATION_MASK_ADVANCE, mode="error",
                                       error=RuntimeError("injected advance fault"), nth=(5,))
    with plan.active():
        handles, sched, _ = serve_grammars(graph, prompts, samplings, request_grammars)
    failed, same = [], []
    for i, (h, ref) in enumerate(zip(handles, streams)):
        try:
            same.append(h.result(0) == ref)
        except PoisonedRequestError as e:
            failed.append((i, e.step, e.reason))
    if len(failed) != 1 or failed[0][1:] != ("mask", "mask_advance") or \
            formats[failed[0][0]] is None or not all(same) or len(plan.events) != 1:
        raise AssertionError(f"constrained: mask_advance fault gave {failed}, survivors {same}")
    stats["quarantine"] = {"failed": failed, "dead_end_failures":
                           sched.constrained_stats.dead_end_failures}
    print("constrained: a mask_advance error quarantined " + json.dumps(stats["quarantine"]))
    if graph.trace_counts != captures["graph"]:
        raise AssertionError(f"constrained: captured again: {graph.trace_counts}")
    for name, engine in engines.items():
        torch.cuda.synchronize()
        if any(m is not None and bool(m.any()) for m in (
                engine._mask1, engine._mask_dec, engine._mask_ver)):
            raise AssertionError(f"constrained: {name}'s grammar masks are not zero")
    stats["masked_steps"] = sum(r["masked_steps"] for r in runs.values())
    stats["mask_bytes_staged"] = {n: e.mask_bytes_staged for n, e in engines.items()}
    stats["engine_masked_steps"] = {n: e.masked_step_count for n, e in engines.items()}
    return stats


def http_generate(base: str, body: dict) -> dict:
    """One POST /v2/models/lm/generate on loopback: the tokens, and the
    client's time.monotonic() stamps (the scheduler's clock) of the
    request's start, its first SSE token event (None for JSON) and its
    end."""
    import urllib.request

    req = urllib.request.Request(base + "/v2/models/lm/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            tokens = json.loads(r.read())["tokens"]
        else:
            events = []
            for line in r:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[len(b"data: "):]))
                    if first is None:
                        first = time.monotonic()
            if not events or not events[-1].get("done") or "tokens" not in events[-1]:
                raise AssertionError(f"server: SSE stream ended without its done event: "
                                     f"{events[-1:]}")
            tokens = events[-1]["tokens"]
            if [e["token"] for e in events[:-1]] != tokens:
                raise AssertionError("server: SSE token events differ from the done event")
    return {"tokens": tokens, "t0": t0, "first": first, "t1": time.monotonic(),
            "prompt_len": len(body["prompt"])}


def http_burst(base: str, bodies) -> dict:
    """Every request at once, one client thread each, then each request's
    time split against the scheduler's own trace of it (found by prompt
    length): before submit (the client's start to the scheduler's
    accept: connection and parse), the scheduler's TTFT, the first SSE
    event's delivery after the scheduler's first token, and the client's
    latency past the scheduler's accept-to-finish span."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(bodies)) as pool:
        results = list(pool.map(lambda b: http_generate(base, b), bodies))
    wall = time.monotonic() - t0
    with urllib.request.urlopen(base + f"/v2/debug/traces?n={len(bodies)}", timeout=60) as r:
        traces = {t["prompt_len"]: t for t in json.loads(r.read())["traces"]}
    sse = [g for g in results if g["first"] is not None]
    tokens = sum(len(g["tokens"]) for g in results)
    tr = [traces[g["prompt_len"]] for g in results]
    pre = [1e3 * (t["t_accept"] - g["t0"]) for g, t in zip(results, tr)]
    delivery = [1e3 * (g["first"] - traces[g["prompt_len"]]["t_accept"]
                       - traces[g["prompt_len"]]["ttft_s"]) for g in sse]
    outside = [(g["t1"] - g["t0"]) - t["total_s"] for g, t in zip(results, tr)]
    return {
        "results": results, "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "http_ttft_p50_s": float(np.median([g["first"] - g["t0"] for g in sse])),
        "trace_ttft_p50_s": float(np.median([traces[g["prompt_len"]]["ttft_s"] for g in sse])),
        "pre_submit_ms_p50": float(np.median(pre)), "pre_submit_ms_max": max(pre),
        "sse_delivery_ms_p50": float(np.median(delivery)), "sse_delivery_ms_max": max(delivery),
        # the client's latency past the scheduler's own span, per token:
        # the front end's host time (connection, parse, writes, reads)
        "front_end_ms_per_token": 1e3 * sum(outside) / tokens,
    }


def server_phase(seed: int, params) -> dict:
    """The serving front end at GPT-2-small width: the port's
    InferenceServer on 127.0.0.1 (port 0) with one GenerationModel over a
    4-slot graph engine (prefix cache on, the overlap pipeline on,
    ``vocabulary=`` the constrained phase's 50257-entry table). Client
    threads post, all at once, the serving cell's 8 requests (half SSE,
    half JSON) twice: cold (the process's first HTTP traffic) and warm;
    then a JSON-schema ``response_format`` request, a ``"speculation":
    {"k": 4}`` request and a best-effort one. Each HTTP stream must equal
    the same request submitted straight to a ContinuousBatchingScheduler
    over the same engine (run first, which also captures every signature
    the traffic needs); the HTTP traffic must capture nothing new and
    launch num_layers paged kernels per decode and verify step; /metrics
    must be a valid exposition whose token total is what the clients
    received."""
    import numpy as np
    import torch
    import urllib.request

    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer

    cfg = gpt2_small()
    vocab = serving_vocabulary(cfg.vocab_size)
    engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16, max_spec_tokens=4,
                              prefix_cache=True)
    model = GenerationModel(engine, name="lm", vocabulary=vocab)
    rs = np.random.RandomState(seed + 10)
    warm(engine, rs)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    sampling = [dict(max_new_tokens=32)] * 6 + [
        dict(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        dict(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    cell = [dict(s, prompt=rs.randint(0, cfg.vocab_size, n).tolist(), stream=bool(i % 2))
            for i, (n, s) in enumerate(zip(lens, sampling))]
    schema = CONSTRAINED_FORMATS[0]
    extras = [
        dict(prompt=rs.randint(0, cfg.vocab_size, 48).tolist(), max_new_tokens=32,
             response_format=schema),
        dict(prompt=rs.randint(0, cfg.vocab_size, 96).tolist(), max_new_tokens=32,
             speculation={"k": 4}, stream=True),
        dict(prompt=rs.randint(0, cfg.vocab_size, 24).tolist(), max_new_tokens=32,
             priority="best_effort"),
    ]
    keys = ("max_new_tokens", "temperature", "top_k", "seed")

    def direct(bodies):
        """The requests straight to a scheduler over the same engine."""
        torch.cuda.synchronize()
        sched = ContinuousBatchingScheduler(engine)
        t0 = time.perf_counter()
        hs = [sched.submit(b["prompt"], SamplingParams(**{k: b[k] for k in keys if k in b}),
                           speculation=(SpeculationConfig(k=b["speculation"]["k"])
                                        if "speculation" in b else None),
                           priority=b.get("priority"),
                           grammar=(model.grammar_cache.get(b["response_format"])
                                    if "response_format" in b else None))
              for b in bodies]
        while not all(h.done() for h in hs):
            sched.step()
        return [h.result(0) for h in hs], time.perf_counter() - t0

    # the reference streams; this also captures the verify signature
    # and compiles the grammar before the HTTP traffic. Each run starts
    # from an empty prefix cache (the bursts repeat the cell's prompts)
    want_extras, _ = direct(extras)
    clear_prefix_cache(engine)
    want_cell, direct_wall = direct(cell)
    clear_prefix_cache(engine)
    captures = dict(engine.trace_counts)
    srv = InferenceServer(port=0)
    srv.register_generation(model)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        counts0 = dict(engine.step_counts)
        hits0 = engine.prefix_cache.hits
        da.reset_launch_counts()
        bursts = {"cold": http_burst(base, cell)}
        clear_prefix_cache(engine)  # the scheduler is idle: nothing runs
        cpu0 = time.process_time()
        bursts["warm"] = http_burst(base, cell)
        cpu_warm = time.process_time() - cpu0
        bursts["extras"] = http_burst(base, extras)
        launches = dict(da.LAUNCHES)
        steps = {k: engine.step_counts[k] - counts0[k] for k in counts0}
        suffix_prefills = engine.prefix_cache.hits - hits0
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            exposition = r.read().decode()
        with urllib.request.urlopen(base + "/v2/stats", timeout=60) as r:
            served = json.loads(r.read())["generation"]["lm"]
    finally:
        srv.stop()
    cell_streams = [[g["tokens"] for g in bursts[n]["results"]] for n in ("cold", "warm")]
    if any(got != want_cell for got in cell_streams):
        raise AssertionError("server: serving cell: HTTP streams differ from the scheduler's")
    if [g["tokens"] for g in bursts["extras"]["results"]] != want_extras:
        raise AssertionError("server: extras: HTTP streams differ from the scheduler's")
    text = check_grammar_text(vocab, bursts["extras"]["results"][0]["tokens"], schema)
    errors = validate_exposition(exposition)
    if errors:
        raise AssertionError(f"server: /metrics is not a valid exposition: {errors[:5]}")
    total = [ln for ln in exposition.splitlines()
             if ln.startswith('flexflow_serving_tokens_generated{model="lm"}')]
    received = sum(b["tokens"] for b in bursts.values())
    if len(total) != 1 or float(total[0].split()[-1]) != received:
        raise AssertionError(f"server: /metrics token total {total} != {received} received")
    if engine.trace_counts != captures or engine.recompiles():
        raise AssertionError(f"server: the HTTP traffic captured {engine.trace_counts} "
                             f"after {captures}")
    expect = cfg.num_layers * (steps["decode"] + steps["verify"] + suffix_prefills)
    if launches["paged_append"] != expect or launches["paged_append_split"]:
        raise AssertionError(f"server: launches {launches} != {cfg.num_layers} layers x "
                             f"({steps} steps, {suffix_prefills} suffix prefills)")
    stats = {
        "requests": 2 * len(cell) + len(extras), "launches": launches, "steps": steps,
        "suffix_prefills": suffix_prefills, "captures": captures,
        "direct_tokens_per_s": sum(len(t) for t in want_cell) / direct_wall,
        "warm_process_cpu_ms_per_token": 1e3 * cpu_warm / bursts["warm"]["tokens"],
        "constrained_text": text, "received_tokens": received,
        "spec_acceptance_rate": served["spec_acceptance_rate"], "rejected": served["rejected"],
        **{name: {k: v for k, v in b.items() if k != "results"} for name, b in bursts.items()},
    }
    print("server (HTTP, 4 slots, graph steps): " + json.dumps(stats))
    return stats


# the parent span of the durable phase's client traceparents (W3C)
DURABLE_PARENT_SPAN = "00f067aa0ba902b7"


class WalTail:
    """Reads the WAL in a directory while its writer appends: each read
    parses only the bytes past the last whole frame it parsed (a frame
    still being written ends that read). ``streams()``: {durable id:
    StreamReplay} of everything whole so far."""

    def __init__(self, wal_dir: str):
        self.dir, self.offsets, self.records = wal_dir, {}, []

    def streams(self) -> dict:
        import struct
        import zlib

        from flexflow_tpu_torch.runtime import wal

        for _, path in wal.list_segments(self.dir):
            start = self.offsets.get(path, 0)
            with open(path, "rb") as f:
                f.seek(start)
                data = f.read()
            off = 0
            while off + 8 <= len(data):
                n, crc = struct.unpack_from("<II", data, off)
                payload = data[off + 8:off + 8 + n]
                if len(payload) < n or zlib.crc32(payload) != crc:
                    break
                self.records.append(json.loads(payload))
                off += 8 + n
            self.offsets[path] = start + off
        return {s.admit["id"]: s for s in wal.replay_streams(self.records)}


def durable_engine(params):
    """The serving cell's engine: GPT-2 small, 4 slots, 257 fp32 blocks of
    16, graph steps, the prefix cache off (as the serving phase's)."""
    from flexflow_tpu_torch.generation.engine import GenerationEngine

    engine = GenerationEngine(params, gpt2_small(), max_batch_slots=4, block_size=16,
                              prefix_cache=False)
    if engine.cache_config.num_blocks != 257 or not engine.graphs:
        raise AssertionError(f"durable: {engine.cache_config.num_blocks} blocks, "
                             f"graphs {engine.graphs}")
    return engine


def durable_child(seed: int, wal_dir: str) -> int:
    """Leg 1 of the durable phase, in its own process (``chip_smoke.py
    --durable-child DIR``): the serving cell's engine behind a
    GenerationModel with durability (fsync on, WAL in ``wal_dir``) and
    journeys on, served by an InferenceServer on 127.0.0.1. Prints one
    JSON line (its port and fingerprint) once it serves, then waits to be
    killed; it exits by itself after 300 s."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
    from flexflow_tpu_torch.serving.durable import DurabilityConfig

    params = params_to(
        init_decoder_params(torch.Generator().manual_seed(seed), gpt2_small()), "cuda")
    engine = durable_engine(params)
    warm(engine, np.random.RandomState(seed + 11))
    model = GenerationModel(engine, name="lm")
    model.enable_durability(DurabilityConfig(wal_dir=wal_dir, fsync=True))
    srv = InferenceServer(port=0)
    srv.register_generation(model)
    srv.start()
    print(json.dumps({"durable_child": {"port": srv.port,
                                        "fingerprint": model.durable.fingerprint}}), flush=True)
    time.sleep(300)
    return 3


def durable_client(base: str, body: dict, traceparent, out: dict) -> None:
    """One generate request; what arrived before the server died stays
    in ``out`` (tokens, SSE event ids, the durable id, the journey id,
    the error that ended it)."""
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if traceparent is not None:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(base + "/v2/models/lm/generate",
                                 data=json.dumps(body).encode(), headers=headers)
    out.update(tokens=[], ids=[], done=None, error=None)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            out["durable_id"] = r.headers.get("X-Durable-Id")
            out["traceparent_out"] = r.headers.get("traceparent")
            if not body["stream"]:
                out["done"] = json.loads(r.read())
                return
            eid = None
            for line in r:
                if line.startswith(b"id: "):
                    eid = int(line[4:])
                elif line.startswith(b"data: "):
                    ev = json.loads(line[6:])
                    if "token" in ev:
                        out["tokens"].append(ev["token"])
                        out["ids"].append(eid)
                    else:
                        out["done"] = ev
    except Exception as e:  # noqa: BLE001 - a killed server ends the request
        out["error"] = repr(e)[:200]


def sse_events(base: str, path: str, last_event_id=None) -> list:
    """GET an SSE endpoint to its end: [(event id or None, data)]."""
    import urllib.request

    headers = {} if last_event_id is None else {"Last-Event-ID": str(last_event_id)}
    with urllib.request.urlopen(urllib.request.Request(base + path, headers=headers),
                                timeout=120) as r:
        text = r.read().decode()
    out = []
    for chunk in text.strip().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in chunk.split("\n"))
        out.append((None if "id" not in lines else int(lines["id"]), json.loads(lines["data"])))
    return out


def durable_leg1(seed: int, cell, wal_dir: str, engine) -> dict:
    """Start the child, warm ``engine`` (leg 2's) while it boots, post the
    serving cell's requests (the 4 JSON ones first, the 4 SSE ones with a
    client traceparent once the JSON ones are admitted), poll the WAL and
    /v2/durable, and SIGKILL the child once every stream holds >= 8
    journaled tokens and one is unfinished."""
    import queue
    import signal
    import threading
    import urllib.request

    import numpy as np

    prompts, samplings, _ = cell
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--durable-child", wal_dir], stdout=subprocess.PIPE, text=True)
    try:
        lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in child.stdout],
                         daemon=True).start()
        t0 = time.perf_counter()
        warm(engine, np.random.RandomState(seed + 11))
        warm_s = time.perf_counter() - t0
        ready = None
        while ready is None:
            try:
                line = lines.get(timeout=max(1.0, 150 - (time.perf_counter() - t0)))
            except queue.Empty:
                raise AssertionError("durable: the child did not start serving") from None
            if line.startswith('{"durable_child"'):
                ready = json.loads(line)["durable_child"]
        boot_s = time.perf_counter() - t0
        base = f"http://127.0.0.1:{ready['port']}"
        reports = []
        polling = threading.Event()

        def poll_durable():
            while not polling.is_set():
                try:
                    with urllib.request.urlopen(base + "/v2/durable", timeout=5) as r:
                        reports.append(json.loads(r.read())["models"]["lm"])
                except Exception:  # noqa: BLE001 - the child is being killed
                    return
                polling.wait(0.02)

        clients, threads = {}, []
        for i, (p, s) in enumerate(zip(prompts, samplings)):
            body = {"prompt": p, "max_new_tokens": s.max_new_tokens,
                    "temperature": s.temperature, "top_k": s.top_k, "seed": s.seed,
                    "stream": bool(i % 2)}
            tp = f"00-{0xd0ab1e00 + i:032x}-{DURABLE_PARENT_SPAN}-01" if body["stream"] else None
            clients[i] = {"body": body, "traceparent": tp}
            threads.append(threading.Thread(target=durable_client,
                                            args=(base, body, tp, clients[i]), daemon=True))
        poller = threading.Thread(target=poll_durable, daemon=True)
        poller.start()
        t_post = time.perf_counter()
        for t in threads[0::2]:  # the JSON requests: the first wave
            t.start()
        tail = WalTail(wal_dir)
        while len(tail.streams()) < 4:
            if time.perf_counter() - t_post > 60:
                raise AssertionError("durable: the JSON requests were not admitted")
            time.sleep(0.001)
        for t in threads[1::2]:  # the SSE requests, with a client traceparent
            t.start()
        polls = 0
        while True:
            streams = tail.streams()
            polls += 1
            if (len(streams) == len(prompts) and all(len(s.tokens) >= 8 for s in streams.values())
                    and any(not s.ended for s in streams.values())):
                os.kill(child.pid, signal.SIGKILL)
                break
            if len(streams) == len(prompts) and all(s.ended for s in streams.values()):
                raise AssertionError("durable: every stream finished before the kill")
            if time.perf_counter() - t_post > 60:
                raise AssertionError(f"durable: no kill point in 60 s ({len(streams)} streams)")
        t_kill = time.perf_counter()
        child.wait(timeout=30)
        polling.set()
        poller.join(timeout=10)
        for t in threads:
            t.join(timeout=30)
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(f"durable: the child exited with {child.returncode}")
        at_kill = WalTail(wal_dir).streams()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    if not reports or reports[-1]["fingerprint"] != ready["fingerprint"]:
        raise AssertionError(f"durable: /v2/durable gave {reports[-1:]}")
    return {"child": ready, "clients": clients, "at_kill": at_kill, "polls": polls,
            "post_to_kill_s": t_kill - t_post, "child_boot_s": boot_s, "warm_s": warm_s,
            "durable_reports": len(reports), "last_report": reports[-1]}


def durable_leg2(engine, cell, wal_dir: str, scan_dir: str, leg1: dict) -> dict:
    """Warm restart in this process: a fresh GenerationModel with
    durability on leg 1's WAL, ``warm_restart()``, then an InferenceServer
    serving the adopted streams to the end, the resume endpoint (from
    event 0 while they run, from each SSE client's Last-Event-ID after)
    and the journeys of the traceparent requests."""
    import shutil
    import threading
    import urllib.request

    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.runtime import wal
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
    from flexflow_tpu_torch.serving.durable import DurabilityConfig

    prompts, _, streams = cell
    want = {tuple(p): s for p, s in zip(prompts, streams)}
    captures = dict(engine.trace_counts)
    # the warm restart's scan, timed on a copy (a scan truncates torn tails)
    os.makedirs(scan_dir)
    for _, path in wal.list_segments(wal_dir):
        shutil.copy(path, scan_dir)
    t0 = time.perf_counter()
    records, torn = wal.scan_wal(scan_dir)
    scan_s = time.perf_counter() - t0
    model = GenerationModel(engine, name="lm")
    dur = model.enable_durability(DurabilityConfig(wal_dir=wal_dir, fsync=True))
    srv = InferenceServer(port=0)
    try:
        t0 = time.perf_counter()
        report = dur.warm_restart()
        restart_s = time.perf_counter() - t0
        adopted = [e.req for e in model.scheduler.journal.entries()]
        n0 = [r.n_generated for r in adopted]
        da.reset_launch_counts()
        decode0 = engine.step_counts["decode"]
        srv.register_generation(model)
        srv.start()
        t_serve = time.perf_counter()
        base = f"http://127.0.0.1:{srv.port}"
        resumed = {}
        threads = [threading.Thread(
            target=lambda r=r: resumed.__setitem__(
                r.durable_id, sse_events(base, f"/v2/generate/resume/{r.durable_id}")),
            daemon=True) for r in adopted]
        for t in threads:
            t.start()
        first = [None] * len(adopted)
        while not all(first) and time.perf_counter() - t_serve < 60:
            now = time.perf_counter()
            for i, r in enumerate(adopted):
                if first[i] is None and (r.n_generated > n0[i] or r.handle.done()):
                    first[i] = now
            time.sleep(0.0002)
        for r in adopted:
            r.handle.result(timeout=120)
        for t in threads:
            t.join(timeout=120)
        launches = dict(da.LAUNCHES)
        decode_steps = engine.step_counts["decode"] - decode0
        # the SSE clients reconnect from the last event id they hold
        tails, journeys = {}, {}
        by_prompt = {tuple(c["body"]["prompt"]): c for c in leg1["clients"].values()}
        for r in adopted:
            c = by_prompt[tuple(r.original_prompt)]
            last = c["ids"][-1] if c["ids"] else None
            tails[r.durable_id] = (last, sse_events(
                base, f"/v2/generate/resume/{r.durable_id}", last_event_id=last))
            if c["traceparent"] is not None:
                trace = c["traceparent"].split("-")[1]
                with urllib.request.urlopen(f"{base}/v2/debug/journey/{trace}", timeout=60) as h:
                    journeys[trace] = json.loads(h.read())["journey"]
        with urllib.request.urlopen(base + "/v2/durable", timeout=60) as h:
            restarted_report = json.loads(h.read())["models"]["lm"]
    finally:
        if srv._httpd is not None:
            srv.stop()  # stops the model's scheduler and closes its Durability
        else:
            dur.close()
    return {"adopted": adopted, "n0": n0, "report": report, "scan_records": len(records),
            "scan_torn": torn, "scan_s": scan_s, "restart_s": restart_s,
            "ttft_s": [f - t0 for f in first if f is not None], "resumed": resumed,
            "tails": tails, "journeys": journeys, "launches": launches,
            "decode_steps": decode_steps, "captures_before": captures,
            "restarted_report": restarted_report, "want": want}


def durable_gates(leg1: dict, leg2: dict, fingerprint: str) -> dict:
    """Every stream token-identical to the serving phase's fault-free run;
    the resume endpoint's events; the journeys; one fingerprint; the
    paged launches and captures of the restarted engine."""
    cfg = gpt2_small()
    want = leg2["want"]
    engine_captures = leg2["captures_before"]
    got = {}
    for s in leg1["at_kill"].values():  # finished before the kill: the journal holds them
        if s.ended:
            if s.outcome != "completed":
                raise AssertionError(f"durable: a stream ended {s.outcome} before the kill")
            got[tuple(s.admit["prompt"])] = s.tokens
    for c in leg1["clients"].values():
        done = c["done"]
        if done is not None and "tokens" in done:  # delivered before the kill
            if list(done["tokens"]) != want[tuple(c["body"]["prompt"])]:
                raise AssertionError("durable: a stream served before the kill differs")
    for r in leg2["adopted"]:
        got[tuple(r.original_prompt)] = r.handle.result(0)
        events = leg2["resumed"][r.durable_id]
        tokens = [e["token"] for _, e in events[:-1]]
        if (tokens != want[tuple(r.original_prompt)] or [i for i, _ in events[:-1]]
                != list(range(len(tokens))) or events[-1][1].get("outcome") != "completed"):
            raise AssertionError(f"durable: resume from event 0 of {r.durable_id}: {events[-1]}")
        last, tail = leg2["tails"][r.durable_id]
        k = 0 if last is None else last + 1
        if [e["token"] for _, e in tail[:-1]] != want[tuple(r.original_prompt)][k:]:
            raise AssertionError(f"durable: resume after Last-Event-ID {last} of {r.durable_id}")
    if set(got) != set(want):
        raise AssertionError(f"durable: {len(got)} of {len(want)} streams accounted for")
    for p, tokens in got.items():
        if list(tokens) != want[p]:
            raise AssertionError(f"durable: the stream of a {len(p)}-token prompt differs "
                                 "from the fault-free run")
    sse = [c for c in leg1["clients"].values() if c["traceparent"] is not None]
    for c in sse:
        trace = c["traceparent"].split("-")[1]
        j = leg2["journeys"].get(trace)
        names = [s["name"] for s in j["spans"]] if j else []
        if (j is None or j["journey_id"] != trace or not j["complete"]
                or not {"submit", "admit", "prefill", "adopt", "warm_restart", "sse_resume",
                        "finish"} <= set(names)):
            raise AssertionError(f"durable: journey {trace}: {names}")
    if leg2["report"]["fingerprint"] != fingerprint or fingerprint != leg1["child"]["fingerprint"]:
        raise AssertionError("durable: the fingerprints of the two legs differ")
    steps = leg2["decode_steps"]
    if (leg2["launches"]["paged_append"] != cfg.num_layers * steps or steps == 0
            or leg2["launches"]["paged_append_split"]):
        raise AssertionError(f"durable: launches {leg2['launches']} != {cfg.num_layers} x "
                             f"{steps} decode steps")
    return {"streams": len(got), "adopted": len(leg2["adopted"]), "journeys": len(sse),
            "captures": engine_captures}


def durable_stretches(engine, seed: int, root: str) -> dict:
    """The steady 4-slot stretch (overlap on, 128 steps) with durability
    off, on with fsync and on without, in turns over two rounds, then with
    journeys on and off: ms per step and the garbage collector's pauses
    in the stretch, and with durability each iteration's flush_step host
    time (its WAL write's longest too), fsyncs per second and WAL bytes
    per token (the stretch's admit records included)."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.serving.durable import Durability, DurabilityConfig

    gc_marks: list = []

    def gc_timer(phase, info):  # the garbage collector's pauses, by generation
        gc_marks.append((phase, info["generation"], time.perf_counter()))

    def gc_pauses():
        out, start = [], {}
        for phase, gen, t in gc_marks:
            if phase == "start":
                start[gen] = t
            elif gen in start:
                out.append((gen, t - start.pop(gen)))
        gc_marks.clear()
        return {"gc_collections": len(out), "gc_ms": 1e3 * sum(d for _, d in out),
                "gc_max_ms": 1e3 * max((d for _, d in out), default=0.0),
                "gc_gen2": sum(g == 2 for g, _ in out)}

    def timed(fn, times):
        def call():
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return call

    rs = np.random.RandomState(seed + 12)
    four = [rs.randint(0, engine.cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    steps = 128
    out: dict = {}
    gc.callbacks.append(gc_timer)
    try:
        for k, mode in enumerate(("off", "fsync", "no_fsync", "no_fsync", "fsync", "off")):
            sched = ContinuousBatchingScheduler(engine)
            dur, flushes, writes = None, [], []
            if mode != "off":
                dur = Durability(sched, DurabilityConfig(
                    wal_dir=os.path.join(root, f"steady{k}"), fsync=mode == "fsync"))
                # flush_step, and inside it the WAL's buffered write
                dur.journal.flush_step = timed(dur.journal.flush_step, flushes)
                dur.wal.flush = timed(dur.wal.flush, writes)
            try:
                c0 = dur.wal.counters() if dur else None
                gc_pauses()
                t0 = time.perf_counter()
                r = steady_stretch(engine, four, True, steps, sched=sched)
                wall = time.perf_counter() - t0
                r.update(gc_pauses())
                if dur:
                    c1 = dur.wal.counters()
                    ms = sorted(1e3 * t for t in flushes)
                    r.update(flush_step_ms_p50=ms[len(ms) // 2],
                             flush_step_ms_p99=ms[min(len(ms) - 1, int(0.99 * len(ms)))],
                             flush_step_ms_max=ms[-1],
                             flush_steps_over_1ms=sum(t > 1.0 for t in ms),
                             wal_write_ms_max=1e3 * max(writes),
                             fsyncs_per_s=(c1["fsyncs"] - c0["fsyncs"]) / wall,
                             wal_bytes_per_token=(c1["bytes"] - c0["bytes"]) / (4 * (steps + 8)),
                             wal_appends=c1["appends"] - c0["appends"])
            finally:
                if dur:
                    dur.close()
            out.setdefault(f"durable_{mode}", []).append(r)
            print(f"durable steady stretch, durability {mode}: " + json.dumps(r))
        for mode in ("on", "off", "off", "on"):
            sched = ContinuousBatchingScheduler(engine, journeys=mode == "on")
            gc_pauses()
            r = steady_stretch(engine, four, True, steps, sched=sched)
            r.update(gc_pauses())
            out.setdefault(f"journeys_{mode}", []).append(r)
            print(f"durable steady stretch, journeys {mode}: " + json.dumps(r))
    finally:
        gc.callbacks.remove(gc_timer)
    return out


def durable_phase(seed: int, params, cell) -> dict:
    """Durable serving and request journeys, killed mid-stream: leg 1 in a
    child process (the serving cell over HTTP, durability with fsync and
    journeys on, SIGKILLed mid-stream), leg 2 in this process (a fresh
    engine and GenerationModel on the same WAL, ``warm_restart()``, served
    to the end), the gates, then the steady stretches with durability and
    journeys on and off."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_durable_")
    try:
        wal_dir = os.path.join(root, "wal")
        engine = durable_engine(params)
        leg1 = durable_leg1(seed, cell, wal_dir, engine)
        leg2 = durable_leg2(engine, cell, wal_dir, os.path.join(root, "scan"), leg1)
        gates = durable_gates(leg1, leg2, leg2["report"]["fingerprint"])
        legs_s = time.perf_counter() - t0
        stretches = durable_stretches(engine, seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if (engine.trace_counts != leg2["captures_before"] or engine.recompiles()
            or any(n != 1 for n in engine.trace_counts.values())):
        raise AssertionError(f"durable: captures {engine.trace_counts} after "
                             f"{leg2['captures_before']}")
    report = leg2["report"]
    at_kill = leg1["at_kill"].values()
    stats = {
        **gates, "fingerprint": report["fingerprint"],
        "child_boot_s": leg1["child_boot_s"], "parent_warm_s": leg1["warm_s"],
        "post_to_kill_s": leg1["post_to_kill_s"], "wal_polls": leg1["polls"],
        "durable_reports_polled": leg1["durable_reports"],
        "journaled_tokens_at_kill": sorted(len(s.tokens) for s in at_kill),
        "ended_at_kill": sum(s.ended for s in at_kill),
        "sse_tokens_at_kill": sorted(len(c["tokens"]) for c in leg1["clients"].values()
                                     if c["body"]["stream"]),
        "torn_records": report["torn_records"], "scan_torn": leg2["scan_torn"],
        "scan_records": leg2["scan_records"], "scan_s": leg2["scan_s"],
        "warm_restart_s": leg2["restart_s"], "replayed_streams": report["replayed_streams"],
        "replayed_tokens": report["replayed_tokens"],
        "resumed_ttft_s": leg2["ttft_s"], "decode_steps": leg2["decode_steps"],
        "launches": leg2["launches"],
        "sse_resume_hops": sum("sse_resume" in [s["name"] for s in j["spans"]]
                               for j in leg2["journeys"].values()),
        "journey_lanes": sorted({ln for j in leg2["journeys"].values() for ln in j["lanes"]}),
        "restarted_wal": leg2["restarted_report"]["wal"],
        "legs_s": legs_s, "steady": stretches, "phase_s": time.perf_counter() - t0,
    }
    print("durable (SIGKILL mid-stream, warm restart): " + json.dumps(
        {k: v for k, v in stats.items() if k != "steady"}))
    return stats


def fleet_factory(params, seed: int, prefix_cache: bool = False, spawns=None, fleet_of=None):
    """Engine factory of the fleet phase: a 4-slot GPT-2-small graph engine
    over the shared weights (257 fp32 blocks of 16), every prefill bucket
    warmed (so its graphs are captured) before the fleet sees it; with the
    prefix cache on, the prefix cell's suffix buckets too (a warm-up
    system prompt of its own, then the index cleared). Each call appends
    (start, end, survivors' decode steps at start and at end) to
    ``spawns``; ``fleet_of()`` names the fleet whose active replicas are
    the survivors (none while the fleet is being built)."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams

    cfg = gpt2_small()
    v = cfg.vocab_size

    def decode_steps():
        f = fleet_of() if fleet_of is not None else None
        if f is None:
            return {}
        return {r.id: r.engine.step_counts["decode"] for r in f.replicas if r.state == "active"}

    def factory():
        t0, before = time.perf_counter(), decode_steps()
        engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16,
                                  prefix_cache=prefix_cache)
        rs = np.random.RandomState(seed + 20)
        warm(engine, rs)
        if prefix_cache:
            wsys = rs.randint(0, v, 512).tolist()
            prompts = [wsys + rs.randint(0, v, n).tolist() for n in (9, 20, 40, 90, 150, 300)]
            prompts += [list(wsys), wsys[:64] + rs.randint(0, v, 700).tolist()]
            engine.generate(prompts, SamplingParams(max_new_tokens=2))
            clear_prefix_cache(engine)
        if spawns is not None:
            spawns.append((t0, time.perf_counter(), before, decode_steps()))
        return engine
    return factory


def fleet_serve(model, prompts, samplings, timeout_s: float = 300.0):
    """Submit every request at once to a started fleet (or model) and wait
    for all: (streams, wall seconds, per-request TTFT seconds by polling
    every 5 ms, handles)."""
    t0 = time.perf_counter()
    handles = [model.submit(p, s) for p, s in zip(prompts, samplings)]
    ttft = [None] * len(handles)
    while not all(h.done() for h in handles):
        now = time.perf_counter()
        if now - t0 > timeout_s:
            raise AssertionError("fleet: requests did not finish")
        for i, h in enumerate(handles):
            if ttft[i] is None and h._request.generated:
                ttft[i] = now - t0
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    ttft = [t if t is not None else wall for t in ttft]
    return [h.result(0) for h in handles], wall, ttft, handles


def fleet_steady(model, engines, seed: int, steps: int = 64) -> dict:
    """Four requests per decoding engine (48-token prompts), once every
    one holds 8 tokens: wall ms per decode step of each engine over
    ``steps`` tokens of each stream (the started fleet's loops step on
    their own threads; this thread polls every 5 ms)."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams

    rs = np.random.RandomState(seed + 21)
    v = gpt2_small().vocab_size
    reqs = [model.submit(rs.randint(0, v, 48).tolist(), SamplingParams(max_new_tokens=steps + 24))
            for _ in range(4 * len(engines))]

    def until(n):
        t_end = time.perf_counter() + 300
        while min(len(h._request.generated) for h in reqs) < n:
            if time.perf_counter() > t_end:
                raise AssertionError("fleet steady stretch stalled")
            time.sleep(0.005)

    until(8)
    c0, t0 = [e.step_counts["decode"] for e in engines], time.perf_counter()
    until(8 + steps)
    wall, c1 = time.perf_counter() - t0, [e.step_counts["decode"] for e in engines]
    for h in reqs:
        h.result(timeout=300)
    ms = [1e3 * wall / max(1, b - a) for a, b in zip(c0, c1)]
    return {"ms_per_step": ms, "steps": [b - a for a, b in zip(c0, c1)],
            "tokens_per_s": len(reqs) * steps / wall}


def fleet_phase(seed: int, params, cell, prefix_cell) -> dict:
    """The fleet on one card at GPT-2-small width (``serving/fleet.py``):
    replicas behind the cache-aware router, each stepping on its own loop
    thread and replaying its own graphs. In order: the single engine
    (a started GenerationModel) for the baseline; ``Fleet(factory, 2)``
    over the serving cell; ``Fleet(factory, 2)`` with the prefix cache
    over the prefix cell; failover: ``replica_kill(plan, "r0", every=1)``
    once each replica holds >= 2 residents, r0's streams journal-replayed
    onto r1 and r0 replaced while r1 serves; ``DisaggregatedFleet`` (one
    prefill and one decode replica) over the serving cell, clean and then
    with a NaN on one handoff block; the serving fleet behind
    ``InferenceServer`` over HTTP (4 SSE + 4 JSON). Every stream must
    equal its single-engine run, and the paged kernel must run on every
    decode step of every replica."""
    import urllib.request

    import numpy as np

    from flexflow_tpu_torch.generation.recovery import RecoveryPolicy
    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.serving import (
        DisaggregatedFleet, Fleet, GenerationModel, InferenceServer)

    cfg = gpt2_small()
    layers = cfg.num_layers
    prompts, samplings, streams = cell
    t_phase = time.perf_counter()
    launches_total = {k: 0 for k in da.LAUNCHES}
    out: dict = {}

    def counted(fn):
        """Run ``fn`` with the launch counts set to 0 just before; returns
        (its result, the launches it made), added to the phase's total."""
        da.reset_launch_counts()
        res = fn()
        got = dict(da.LAUNCHES)
        for k, n in got.items():
            launches_total[k] += n
        return res, got

    def run_stats(streams_, wall, ttft):
        tokens = sum(len(s) for s in streams_)
        return {"wall_s": wall, "tokens_per_s": tokens / wall,
                "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": float(max(ttft))}

    def decode_steps(engines):
        return sum(e.step_counts["decode"] for e in engines)

    # 0. the single engine, threaded like a replica
    factory = fleet_factory(params, seed)
    single = GenerationModel(factory(), name="lm")
    single.start()
    try:
        (got, wall, ttft, _), launches = counted(lambda: fleet_serve(single, prompts, samplings))
        if got != streams:
            raise AssertionError("fleet: the single engine's threaded streams differ")
        out["single"] = {**run_stats(got, wall, ttft), "launches": launches,
                         "steady": fleet_steady(single, [single.engine], seed)}
    finally:
        single.stop()
    del single

    # 1. Fleet(factory, 2) over the serving cell (kept for the HTTP leg)
    t0 = time.perf_counter()
    fleet = Fleet(factory, 2, name="lm", poll_s=0.05)
    build_s = time.perf_counter() - t0
    fleet.start()
    engines = [r.engine for r in fleet.replicas]
    d0 = decode_steps(engines)
    (got, wall, ttft, _), launches = counted(lambda: fleet_serve(fleet, prompts, samplings))
    steps = decode_steps(engines) - d0
    if got != streams:
        raise AssertionError("fleet serving cell: streams differ from the serving phase's")
    if launches["paged_append"] != layers * steps or launches["paged_append_split"]:
        raise AssertionError(f"fleet serving cell: launches {launches} != {layers} x {steps}")
    out["fleet"] = {**run_stats(got, wall, ttft), "launches": launches, "decode_steps": steps,
                    "build_s": build_s, "decisions": fleet.fleet_stats.decisions(),
                    "per_replica_decode_steps": [e.step_counts["decode"] for e in engines],
                    "steady": fleet_steady(fleet, engines, seed)}
    print("fleet serving cell (2 replicas): " + json.dumps(out["fleet"]))

    # 2. the prefix cell through Fleet(factory, 2) with the prefix cache on
    p_prompts, p_samplings, p_streams = prefix_cell
    pfleet = Fleet(fleet_factory(params, seed, prefix_cache=True), 2, name="lm-prefix",
                   poll_s=0.05)
    pfleet.start()
    try:
        hits0 = {r.id: r.engine.prefix_cache.hits for r in pfleet.replicas}
        (got, wall, ttft, _), launches = counted(
            lambda: fleet_serve(pfleet, p_prompts, p_samplings))
        decisions = pfleet.fleet_stats.decisions()
        hits = {r.id: r.engine.prefix_cache.hits - hits0[r.id] for r in pfleet.replicas}
        holds = {r.id: r.engine.prefix_cache.probe(p_prompts[0][:512]) for r in pfleet.replicas}
    finally:
        pfleet.stop()
    if got != p_streams:
        raise AssertionError("fleet prefix cell: streams differ from the single engine's")
    if not decisions.get("affinity"):
        raise AssertionError(f"fleet prefix cell: no affinity decision: {decisions}")
    if not sum(hits.values()) or any(n and not holds[rid] for rid, n in hits.items()):
        raise AssertionError(f"fleet prefix cell: hits {hits} on replicas holding {holds}")
    out["prefix"] = {**run_stats(got, wall, ttft), "launches": launches,
                     "decisions": decisions, "hits": hits, "prefix_tokens_held": holds}
    print("fleet prefix cell (2 replicas, prefix cache on): " + json.dumps(out["prefix"]))
    del pfleet

    # 3. failover: r0 killed with >= 2 residents on each replica
    spawns, holder = [], {}
    ffleet = Fleet(fleet_factory(params, seed, spawns=spawns, fleet_of=lambda: holder.get("f")),
                   2, name="lm-failover", poll_s=0.05,
                   scheduler_kwargs=dict(recovery=RecoveryPolicy(max_restarts=1)))
    holder["f"] = ffleet
    r0, r1 = ffleet.replicas
    survivor_captures = dict(r1.engine.trace_counts)
    ffleet.start()
    plan = faults.FaultPlan(seed=seed)
    faults.replica_kill(plan, "r0", every=1)
    try:
        def failover_run():
            t0 = time.perf_counter()
            handles = [ffleet.submit(p, s) for p, s in zip(prompts, samplings)]
            while min(len(r.scheduler._running) for r in (r0, r1)) < 2:
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("failover: the replicas never held 2 residents each")
                time.sleep(0.001)
            plan.install()
            for h in handles:
                h.result(timeout=300)
            while ffleet.fleet_stats.replaced < 1 and time.perf_counter() - t0 < 300:
                time.sleep(0.01)
            return [h.result(0) for h in handles], time.perf_counter() - t0, handles

        (got, wall, handles), launches = counted(failover_run)
    finally:
        plan.remove()
        ffleet.stop()
    fs = ffleet.fleet_stats.snapshot()
    if got != streams:
        raise AssertionError("failover: streams differ from the fault-free run")
    if fs["failovers"] < 1 or fs["replaced"] != 1 or fs["migrated_streams"] < 2:
        raise AssertionError(f"failover: fleet counters {fs}")
    spawn = spawns[-1]
    if len(spawns) != 3 or not spawn[2] or not any(
            spawn[3].get(rid, 0) > n for rid, n in spawn[2].items()):
        raise AssertionError(f"failover: the replacement's spawn did not overlap the survivor's "
                             f"serving: {spawns}")
    if r1.engine.trace_counts != survivor_captures or r1.engine.recompiles():
        raise AssertionError(f"failover: the survivor captured {r1.engine.trace_counts} after "
                             f"{survivor_captures}")
    out["failover"] = {
        "wall_s": wall, "launches": launches, "fleet": fs,
        "replays": [h._request.replays for h in handles],
        "replacement_spawn_capture_s": spawn[1] - spawn[0],
        "survivor_decode_steps_during_spawn": {rid: spawn[3].get(rid, 0) - n
                                               for rid, n in spawn[2].items()},
        "r0_resets": r0.engine.resets,
        "states": ffleet.states(),
    }
    print("fleet failover (r0 killed mid-stream): " + json.dumps(out["failover"]))
    del ffleet, r0, r1

    # 4 and 5. disaggregated: one prefill and one decode replica
    dfleet = DisaggregatedFleet(factory, n_prefill=1, n_decode=1, name="lm-disagg", poll_s=0.05)
    pre, dec = dfleet.prefill.replicas[0], dfleet.decode.replicas[0]
    pack_ms, import_ms = [], []

    def timed(engine, name, rec):
        fn = getattr(engine, name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            rec.append(1e3 * (time.perf_counter() - t0))
            return res
        setattr(engine, name, call)

    timed(pre.engine, "pack_kv_blocks", pack_ms)
    timed(dec.engine, "import_kv_blocks", import_ms)
    head = cfg.hidden_size // cfg.num_heads
    block_bytes = layers * 16 * cfg.num_heads * head * 4 * 2
    want_bytes = sum(-(-len(p) // 16) for p in prompts) * block_bytes
    dfleet.start()
    try:
        def snap():
            rs_ = dec.scheduler.recovery_stats
            return {"imports": rs_.kv_imports, "rejected": rs_.kv_imports_rejected,
                    "bytes": dfleet.handoff.bytes_total, "replays": dfleet.handoff.replay_fallbacks,
                    "transfers": dict(dfleet.handoff.transfers),
                    "dec_prefill": dec.engine.step_counts["prefill"],
                    "dec_decode": dec.engine.step_counts["decode"],
                    "pre_decode": pre.engine.step_counts["decode"]}

        s0 = snap()
        (got, wall, ttft, _), launches = counted(lambda: fleet_serve(dfleet, prompts, samplings))
        s1 = snap()
        delta = {k: s1[k] - s0[k] for k in s0 if k != "transfers"}
        if got != streams:
            raise AssertionError("disaggregated: streams differ from the serving phase's")
        if (delta["imports"], delta["rejected"], delta["replays"]) != (len(prompts), 0, 0):
            raise AssertionError(f"disaggregated: handoff counters {delta}")
        if delta["dec_prefill"] or delta["pre_decode"]:
            raise AssertionError(f"disaggregated: the decode replica prefilled or the prefill "
                                 f"replica decoded: {delta}")
        if launches["paged_append"] != layers * delta["dec_decode"] or \
                launches["paged_append_split"]:
            raise AssertionError(f"disaggregated: launches {launches} != {layers} x "
                                 f"{delta['dec_decode']} decode-pool steps")
        if delta["bytes"] != want_bytes:
            raise AssertionError(f"disaggregated: payload bytes {delta['bytes']} != {want_bytes}")
        out["disagg"] = {**run_stats(got, wall, ttft), "launches": launches, "counters": delta,
                         "payload_bytes": delta["bytes"],
                         "pack_ms_p50": float(np.median(pack_ms[-len(prompts):])),
                         "pack_ms_max": max(pack_ms[-len(prompts):]),
                         "import_ms_p50": float(np.median(import_ms[-len(prompts):])),
                         "import_ms_max": max(import_ms[-len(prompts):]),
                         "steady": fleet_steady(dfleet, [dec.engine], seed)}
        print("disaggregated serving cell (1 prefill + 1 decode): " + json.dumps(out["disagg"]))

        plan = faults.FaultPlan(seed=seed)
        plan.on(faults.FLEET_KV_HANDOFF, mode="nan", nth=(0,))
        s0 = snap()
        with plan.active():
            (got, wall, ttft, _), launches = counted(
                lambda: fleet_serve(dfleet, prompts, samplings))
        s1 = snap()
        corrupt = s1["transfers"]["corrupt"] - s0["transfers"]["corrupt"]
        delta = {k: s1[k] - s0[k] for k in s0 if k != "transfers"}
        if got != streams:
            raise AssertionError("disaggregated, corrupt block: streams differ")
        if corrupt != 1 or delta["replays"] != 1 or delta["imports"] != len(prompts) - 1:
            raise AssertionError(f"disaggregated, corrupt block: corrupt {corrupt}, {delta}")
        out["disagg_corrupt"] = {**run_stats(got, wall, ttft), "launches": launches,
                                 "corrupt": corrupt, "counters": delta,
                                 "fires": plan.fired(faults.FLEET_KV_HANDOFF)}
        print("disaggregated, NaN on one handoff block: " + json.dumps(out["disagg_corrupt"]))
    finally:
        dfleet.stop()
    del dfleet, pre, dec

    # 6. the serving fleet behind the HTTP front end
    srv = InferenceServer(port=0)
    srv.register_generation(fleet)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        keys = ("max_new_tokens", "temperature", "top_k", "seed")
        bodies = [dict({k: getattr(s, k) for k in keys if getattr(s, k) is not None},
                       prompt=p, stream=bool(i % 2))
                  for i, (p, s) in enumerate(zip(prompts, samplings))]
        burst, launches = counted(lambda: http_burst(base, bodies))
        docs = {}
        for path in ("/v2/fleet", "/v2/fleet/autoscale", "/metrics"):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                docs[path] = r.read().decode()
    finally:
        srv.stop()
    if [g["tokens"] for g in burst["results"]] != streams:
        raise AssertionError("fleet over HTTP: streams differ from the serving phase's")
    report = json.loads(docs["/v2/fleet"])["models"]["lm"]
    autoscale = json.loads(docs["/v2/fleet/autoscale"])["models"]["lm"]
    if sorted(r["id"] for r in report["replicas"]) != ["r0", "r1"] or \
            autoscale["signal"] not in (-1, 0, 1) or autoscale["current_replicas"] != 2:
        raise AssertionError(f"fleet over HTTP: /v2/fleet {report['replicas']}, "
                             f"/v2/fleet/autoscale {autoscale}")
    errors = validate_exposition(docs["/metrics"])
    fam = 'flexflow_serving_fleet_replicas{model="lm",state="active"} 2'
    if errors or fam not in docs["/metrics"] or 'replica="r1"' not in docs["/metrics"]:
        raise AssertionError(f"fleet over HTTP: /metrics {errors[:5]}, fleet families missing")
    out["http"] = {k: v for k, v in burst.items() if k != "results"}
    out["http"].update(launches=launches, router_decisions=report["router_decisions"])
    print("fleet over HTTP (4 SSE + 4 JSON): " + json.dumps(out["http"]))
    del fleet
    import torch

    torch.cuda.empty_cache()
    out["launches"] = launches_total
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# the tools phase's loadgen legs: (name, rate/s, seconds, seed)
TOOLS_LEGS = (("under capacity", 12.0, 4.0, 1), ("overload", 80.0, 2.0, 2))
TOOLS_MAX_QUEUE = 16
# the ledger export's device tag on the card (``compute.chip``), and a tag
# whose cost table must refuse the card's measurements
CARD_TAG, OTHER_TAG = "h100", "cpu"


def captured_view(fn, *args, **kw) -> tuple:
    """Run one of obsreport's views, returning (exit code, its text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue()


def metric_total(exposition: str, family: str, model: str = "lm") -> float:
    rows = [ln for ln in exposition.splitlines() if ln.startswith(f'{family}{{model="{model}"}}')]
    if len(rows) != 1:
        raise AssertionError(f"tools: /metrics has {len(rows)} {family} rows for {model}")
    return float(rows[0].split()[-1])


def tools_phase(seed: int, params, card: str) -> dict:
    """The port's serving tools (``flexflow_tpu_torch/tools``) driven on the
    card at GPT-2-small width, through their own functions:

    1. genbench's base mode (12 requests of 4-1007 prompt tokens, 16 new
       tokens, 4 slots, graph steps): one capture per prefill bucket and
       one decode, none after the warm-up, no reset / quarantine /
       watchdog trip, greedy streams equal to ``engine.generate``'s, 12
       fp32 paged launches per decode step; its prefill and decode
       tokens/s;
    2. loadgen ``--url`` against an ``InferenceServer`` serving that
       engine (max_queue 16): 12 arrivals/s for 4 s, then 80/s for 2 s,
       mix 0.2,0.3,0.5, deadlines none,5,30 s, 32 new tokens: answers only
       200, 503 or 504, none failed, the first leg sheds nothing, every
       200's tokens equal ``engine.generate``'s stream (a prefix of it
       where the degrade ladder clamped max_new), loadgen's token total
       equal to /metrics', no capture during the traffic;
    3. obsreport's summary, cache, slo, anatomy and predict views render
       against that server; ``predict --export`` writes the card's ledger,
       which ``SimCosts.from_ledger_export(expect_device="h100")`` turns
       into prefill and decode costs from its measured p50s and which it
       refuses under ``expect_device="cpu"``; ``simfleet sweep --costs``
       over it, twice, gives byte-identical reports;
    4. ``simfleet simcheck`` with its live storm on the card;
    5. chaoscheck's recovery sweep on the card;
    6. perfwatch over the history the base run and a second base run
       appended: exit 0.
    """
    import tempfile
    import shutil
    import urllib.request

    import torch

    from flexflow_tpu_torch.generation import SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
    from flexflow_tpu_torch.sim import SimCosts
    from flexflow_tpu_torch.tools import chaoscheck, genbench, loadgen, obsreport, perfwatch
    from flexflow_tpu_torch.tools import simfleet
    from flexflow_tpu_torch.tools._common import pct

    t_phase = time.perf_counter()
    cfg = gpt2_small()
    tmp = tempfile.mkdtemp(prefix="tools-phase-")
    out = {}
    da.reset_launch_counts()
    try:
        # ---------------------------------------------- 1. genbench base mode
        history = os.path.join(tmp, "history.jsonl")
        args = genbench.parse_args([
            "--requests", "12", "--max-new", "16", "--layers", str(cfg.num_layers),
            "--hidden", str(cfg.hidden_size), "--heads", str(cfg.num_heads),
            "--vocab", str(cfg.vocab_size), "--seq-len", str(cfg.seq_length),
            "--bench-out", os.path.join(tmp, "bench.json"), "--history-out", history])
        bases = []
        for i in range(2):
            before = dict(da.LAUNCHES)
            report, ok, outs, engine, prompts = genbench.base_bench(args, cfg, params)
            launches = {k: da.LAUNCHES[k] - before[k] for k in da.LAUNCHES}
            genbench.append_history(history, "baseline", report, ok, args.device)
            if not ok:
                raise AssertionError(f"tools: genbench base run {i} failed its guard: "
                                     + json.dumps({k: report[k] for k in (
                                         "trace_counts", "steady_state_retraces",
                                         "engine_restarts", "quarantined", "watchdog_trips")}))
            counts = report["trace_counts"]
            buckets = {f"prefill[{engine.bucket_for(len(p))}]" for p in prompts + [[1] * 8]}
            if counts.get("decode") != 1 or any(v != 1 for v in counts.values()) or (
                    {k for k in counts if k.startswith("prefill[")} - buckets):
                raise AssertionError(f"tools: captures {counts}, buckets {sorted(buckets)}")
            if report["steady_state_retraces"] or any(report[k] for k in (
                    "engine_restarts", "quarantined", "watchdog_trips")):
                raise AssertionError(f"tools: genbench run {i}: {report}")
            # every decode step launches 12 kernels; the step that captures
            # the decode graph runs its body once eagerly first (its
            # launches are real), the capture itself launches nothing
            decode_steps = engine.step_counts["decode"]
            ran = decode_steps + (counts["decode"] if engine.graphs else 0)
            if launches["paged_append"] != cfg.num_layers * ran or any(
                    n for k, n in launches.items() if k != "paged_append"):
                raise AssertionError(f"tools: genbench launches {launches} != "
                                     f"{cfg.num_layers} x ({decode_steps} decode steps + "
                                     f"{counts['decode']} capture warm-up)")
            want = engine.generate(prompts, SamplingParams(max_new_tokens=args.max_new))
            if outs != want:
                raise AssertionError("tools: genbench streams differ from engine.generate's")
            bases.append({k: report[k] for k in (
                "prompt_tokens", "generated_tokens", "scheduler_steps", "stream_s",
                "prefill_tokens_per_s", "decode_tokens_per_s", "trace_counts", "warmup_s")}
                | {"decode_steps": decode_steps, "launches": launches})
            if i == 0:
                served = engine
            else:
                del engine
        out["genbench"] = bases
        for i, b in enumerate(bases):
            print(f"{card}: tools, genbench base run {i} (GPT-2 small, 4 slots, 12 requests, "
                  f"{b['prompt_tokens']} prompt + {b['generated_tokens']} new tokens): prefill "
                  f"{b['prefill_tokens_per_s']:.2f} tokens/s, decode "
                  f"{b['decode_tokens_per_s']:.2f} tokens/s over the stream of "
                  f"{b['stream_s']:.4f} s; captures {b['trace_counts']}; "
                  f"{b['launches']['paged_append']} paged launches for {b['decode_steps']} "
                  "decode steps and the decode capture's eager warm-up")

        # ------------------------------------------------------ 2. loadgen --url
        served.generate([[1] * 8], SamplingParams(max_new_tokens=2))  # the prompts' bucket
        model = GenerationModel(served, name="lm", vocabulary=serving_vocabulary(cfg.vocab_size),
                                max_queue=TOOLS_MAX_QUEUE)
        srv = InferenceServer(port=0)
        srv.register_generation(model)
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            captures = dict(served.trace_counts)
            steps0 = dict(served.step_counts)
            before = dict(da.LAUNCHES)
            legs = {}

            def served_tokens():
                with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                    return metric_total(r.read().decode(), "flexflow_serving_tokens_generated")

            for name, rate, duration, leg_seed in TOOLS_LEGS:
                tokens0 = served_tokens()
                largs = loadgen.parse_args([
                    "--url", base, "--model", "lm", "--rate", str(rate),
                    "--duration", str(duration), "--mix", "0.2,0.3,0.5",
                    "--deadlines", "none,5,30", "--max-new", "32", "--seed", str(leg_seed),
                    "--vocab", str(cfg.vocab_size), "--timeout", "120"])
                rep = loadgen.LoadReport()
                t0 = time.perf_counter()
                rendered = loadgen.run_http(largs, rep)
                legs[name] = {"report": rendered, "wall_s": time.perf_counter() - t0,
                              "streams": rep.streams(), "ttfts": rep.ttfts(),
                              "metrics_tokens": served_tokens() - tokens0}
            launches = {k: da.LAUNCHES[k] - before[k] for k in da.LAUNCHES}
            steps = {k: served.step_counts[k] - steps0[k] for k in steps0}
            if served.trace_counts != captures:
                raise AssertionError(f"tools: the load captured {served.trace_counts} "
                                     f"after {captures}")
            # ---------------------------------------------------- 3. obsreport
            for view, fn, kw in (("summary", obsreport.summarize, {}),
                                 ("cache", obsreport.show_cache, {}),
                                 ("slo", obsreport.show_slo, {}),
                                 ("anatomy", obsreport.show_anatomy, {}),
                                 ("predict", obsreport.show_predictions, {})):
                rc, text = captured_view(fn, base, **kw)
                if rc != 0 or not text.strip():
                    raise AssertionError(f"tools: obsreport {view} did not render: {rc}")
                print(f"obsreport {view}:\n{text.rstrip()}")
            export = os.path.join(tmp, "ledger.json")
            rc, text = captured_view(obsreport.export_predictions, base, export)
            if rc != 0:
                raise AssertionError("tools: obsreport predict --export failed")
        finally:
            srv.stop()
        for name, leg in legs.items():
            rendered = leg["report"]
            per = rendered["per_priority"]
            if rendered["unfinished"] or any(p["failed"] for p in per.values()):
                raise AssertionError(f"tools: loadgen {name}: failed or unfinished "
                                     f"requests: {rendered}")
            if name == "under capacity" and any(p["shed"] for p in per.values()):
                raise AssertionError(f"tools: loadgen {name} shed requests: {per}")
            # the server's count of generated tokens equals what the
            # clients received where nothing was dropped once running (the
            # first leg); under overload it also holds the tokens of
            # streams shed or cancelled after they started
            leg["received_tokens"] = sum(p["tokens"] for p in per.values())
            dropped = leg["metrics_tokens"] - leg["received_tokens"]
            if dropped < 0 or (name == "under capacity" and dropped):
                raise AssertionError(f"tools: loadgen {name}: /metrics counted "
                                     f"{leg['metrics_tokens']} tokens, the clients received "
                                     f"{leg['received_tokens']}")
        # the reference streams, batched (a request's tokens do not depend
        # on its batch)
        uniq = sorted({tuple(p) for leg in legs.values() for p, _ in leg["streams"]})
        refs = dict(zip(uniq, served.generate([list(p) for p in uniq],
                                              SamplingParams(max_new_tokens=32))))
        clamped = 0
        for leg in legs.values():
            for prompt, tokens in leg["streams"]:
                if not tokens or tokens != refs[tuple(prompt)][:len(tokens)]:
                    raise AssertionError(f"tools: a 200's tokens differ from "
                                         f"engine.generate's for {prompt}")
                clamped += len(tokens) < 32
        if launches["paged_append"] != cfg.num_layers * (steps["decode"] + steps["verify"]):
            raise AssertionError(f"tools: load launches {launches} for steps {steps}")

        with open(export) as f:
            doc = json.load(f)
        tag = doc["models"]["lm"]["device_kind"]
        costs = SimCosts.from_ledger_export(export, expect_device=CARD_TAG)
        measured = {e["key"]: e["measured_p50_s"] for e in doc["models"]["lm"]["entries"]
                    if e["pairs"] > 0}
        if tag != CARD_TAG or costs.decode_s != measured.get("decode") or not costs.prefill_s or any(
                costs.prefill_s[b] != measured.get(f"prefill[{b}]", costs.prefill_s[b])
                for b in costs.prefill_s) or not any(
                k.startswith("prefill[") for k in measured):
            raise AssertionError(f"tools: the card's export ({tag}) did not calibrate the "
                                 f"twin from its measured p50s: {costs.describe()} vs {measured}")
        try:
            SimCosts.from_ledger_export(export, expect_device=OTHER_TAG)
            raise AssertionError(f"tools: a {OTHER_TAG} cost table accepted the card's ledger")
        except ValueError:
            pass
        sweeps = []
        for i in range(2):
            path = os.path.join(tmp, f"sweep{i}.json")
            rc, text = captured_view(simfleet.main, [
                "sweep", "--costs", export, "--expect-device", CARD_TAG,
                "--arms", "unified,disagg", "--replicas", "1,2", "--out", path])
            if rc != 0:
                raise AssertionError(f"tools: simfleet sweep exited {rc}")
            with open(path, "rb") as f:
                sweeps.append(f.read())
        if sweeps[0] != sweeps[1]:
            raise AssertionError("tools: two simfleet sweeps over the card's ledger differ")
        print(f"simfleet sweep over the card's ledger:\n{text.rstrip()}")

        # --------------------------------------------------- 4. simcheck
        sim_out = os.path.join(tmp, "simcheck.json")
        rc, text = captured_view(simfleet.main, ["simcheck", "--out", sim_out])
        print(text.rstrip())
        with open(sim_out) as f:
            simcheck = json.load(f)
        if rc != 0 or not simcheck["ok"]:
            raise AssertionError(f"tools: simcheck failed: {simcheck['failures']}")

        # --------------------------------------------- 5. recovery sweep
        sweep, text = captured_view(chaoscheck.run_recovery_sweep)
        print(text.rstrip())
        if not sweep["ok"] or not all(sweep[c].get("exact", True) for c in (
                "crash", "stall", "double_fault")):
            raise AssertionError(f"tools: the recovery sweep failed on the card: {sweep}")

        # ------------------------------------------------------ 6. perfwatch
        rc, text = captured_view(perfwatch.main, ["--history", history])
        print(text.rstrip())
        if rc != 0:
            raise AssertionError(f"tools: perfwatch exited {rc}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["loadgen"] = {
        name: {"report": leg["report"], "wall_s": leg["wall_s"],
               "metrics_tokens": leg["metrics_tokens"], "received_tokens": leg["received_tokens"],
               "ttft_p50_s": {p: pct(t, 0.50) for p, t in leg["ttfts"].items()},
               "ttft_p99_s": {p: pct(t, 0.99) for p, t in leg["ttfts"].items()}}
        for name, leg in legs.items()}
    out["loadgen_steps"] = steps
    out["loadgen_launches"] = launches
    out["clamped_streams"] = clamped
    out["export"] = {"device_kind": tag, "costs": costs.describe(), "measured_p50_s": measured}
    out["simcheck"] = {k: simcheck[k] for k in ("divergence", "ledger_keys", "bound_s")}
    out["recovery_sweep"] = sweep
    out["launches"] = dict(da.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    for name, leg in out["loadgen"].items():
        r = leg["report"]
        print(f"{card}: tools, loadgen --url {name} ({r['submitted']} arrivals over "
              f"{r['duration_s']} s, wall {leg['wall_s']:.2f} s): " + "; ".join(
                  f"{p} submitted {d['submitted']} completed {d['completed']} shed {d['shed']} "
                  f"expired {d['expired']} response latency (loadgen's TTFT) p50 "
                  f"{_fmt(leg['ttft_p50_s'][p])} s p99 "
                  f"{_fmt(leg['ttft_p99_s'][p])} s" for p, d in r["per_priority"].items())
              + f"; tokens/s {r['tokens_per_s']:.1f}; tokens received {leg['received_tokens']}, "
              f"counted by /metrics {leg['metrics_tokens']:.0f}")
    c = out["export"]["costs"]
    print(f"{card}: tools, the card's ledger ({tag}) calibrating the twin: "
          + json.dumps(c) + f"; simcheck divergence " + json.dumps(out["simcheck"]["divergence"]))
    print(f"{card}: tools phase {out['phase_s']:.1f} s")
    return out


def _fmt(x) -> str:
    return "-" if x is None else f"{x:.4f}"


def flash_bound(kind: str, b: int, sq: int, sk: int, h: int, d: int, causal: bool,
                two_byte: bool = False):
    """(bound_ms, bound_by, fp32_cuda_core_ms) of one flash kernel call:
    each input read once and each output written once over the card's
    memory rate, against the multiply-adds the kernel does on the
    unmasked (query, key) pairs (2 flops each: QK and PV forward; QK,
    dO.V and dS.K for dQ; QK, dO.V, P^T dO and dS^T Q for dK/dV) taken
    to fp32 accuracy on the tensor cores, three TF32 products each at
    the dense TF32 rate (datasheet figures); for the bf16 and fp16 forms,
    2-byte q, k, v, o, dO and gradients (lse and delta stay 4) and the
    same operations at the dense bf16 / fp16 rate (the same 989 TFLOP/s).
    fp32_cuda_core_ms is the larger
    of the byte time and those operations at the fp32 CUDA-core rate."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    e = 2 if two_byte else 4  # bytes an element of q, k, v, o, dO, dq, dk, dv
    q_elems, kv_elems, rows = b * sq * h * d, b * sk * h * d, b * sq * h
    if kind == "fwd":
        flops = 2 * 2 * d * pairs
        nbytes = e * (2 * q_elems + 2 * kv_elems) + 4 * rows  # q, o; k, v; lse
    elif kind == "dq":
        flops = 3 * 2 * d * pairs
        nbytes = e * (3 * q_elems + 2 * kv_elems) + 8 * rows  # q, dO, dq; k, v; lse, delta
    else:
        flops = 4 * 2 * d * pairs
        nbytes = e * (2 * q_elems + 4 * kv_elems) + 8 * rows  # q, dO; k, v, dk, dv; lse, delta
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (flops / H100_BF16_FLOPS if two_byte else TF32_PRODUCTS * flops / H100_TF32_FLOPS) * 1e3
    fp32_ms = max(t_bytes, flops / H100_FP32_FLOPS * 1e3)
    return (t_bytes, "bytes", fp32_ms) if t_bytes >= t_ops else (t_ops, "operations", fp32_ms)


def ptxas_report(log: str) -> list:
    """[(kernel instance, "N registers, spills")] from nvcc's ptxas -v log:
    each entry function by its mangled name past the source's namespace."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN\w*?_cu_[0-9a-f]+\d+(\w+)'", line)
        if m:
            name, spill = m.group(1).split("EEv")[0], ""  # up to the template arguments
        elif name and "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split("Used", 1)[1].split(",")[0].strip() + ", " + spill))
            name = None
    return out


def library_sass(source: str) -> str:
    """cuobjdump -sass of the built library of ``csrc/<source>``."""
    from flexflow_tpu_torch.ops.kernels import _build

    src = next(p for p in _build.kernel_sources() if p.name == source)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(_build.library_path(src))],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def tensor_core_check() -> dict:
    """The built flash library's SASS (cuobjdump -sass) must hold
    tensor-core HMMA instructions (mma.sync) in every instance of the
    forward, dQ and dK/dV mma.sync kernels, float32, bf16 and fp16 forms
    (the 2-byte forms are the body the wgmma bodies leave calls to), and
    warpgroup GMMA instructions (HGMMA, wgmma) in every instance of the
    bf16 and fp16 wgmma forward, dQ and dK/dV (head dims padded to 64 and
    128); the CUDA-core dQ must exist only for head dims above 128 (5..8,
    12 and 16 columns of 32) in all three forms; the paged library's, in every instance
    of the tensor-core body (fp32, bf16 and fp16 caches, single-pass and
    split, head dims padded to 32, 64 and 128). Raises otherwise. Returns
    ({kernel<head-dim pad,form>: HMMA count}, {wgmma kernel<pad,form>:
    HGMMA count})."""
    paged_tensor_core_check()
    sass = library_sass("flash_attention.cu")
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : .*?(flash_[a-z_]+_kernel)ILi(\d+)E(f|13__nv_bfloat16|6__half)E",
                      line)
        if m:
            form = {"f": ",f32", "13__nv_bfloat16": ",bf16", "6__half": ",f16"}[m.group(3)]
            name = f"{m.group(1)}<{m.group(2)}{form}>"
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif "Function : " in line:
            name = None
        elif name is not None:
            for op in ("HMMA", "HGMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    found = {}
    for kernel in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel"):
        inst = {n: c["HMMA"] for n, c in counts.items() if n.startswith(kernel + "<")}
        if len(inst) != 12 or not all(inst.values()):
            raise AssertionError(f"{kernel}: expected HMMA in 4 head dims x 3 forms, got "
                                 f"{inst or 'none in the built library'}")
        found.update(inst)
    wgmma = {}
    for kernel in ("flash_fwd_wg_kernel", "flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel"):
        inst = {n: c["HGMMA"] for n, c in counts.items() if n.startswith(kernel + "<")}
        want = sorted(f"{kernel}<{d},{f}>" for d in (64, 128) for f in ("bf16", "f16"))
        if sorted(inst) != want or not all(inst.values()):
            raise AssertionError(f"{kernel}: expected HGMMA in head dims 64 and 128, bf16 "
                                 f"and fp16, got "
                                 f"{inst or 'none in the built library'}")
        wgmma.update(inst)
    simt_dq = sorted(n[n.index("<") + 1:-1] for n in counts if n.startswith("flash_bwd_dq_kernel<"))
    want = sorted(f"{c},{f}" for c in (5, 6, 7, 8, 12, 16) for f in ("f32", "bf16", "f16"))
    if simt_dq != want:
        raise AssertionError(f"CUDA-core dQ instances {simt_dq}: expected only D > 128 ({want})")
    return found, wgmma


def paged_tensor_core_check() -> dict:
    """HMMA counts of the paged library's tensor-core body, by instance
    (cache form, single-pass or split, head-dim pad); raises unless all 18
    instances hold HMMA and the CUDA-core body holds none."""
    forms = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    counts, name, simt_hmma = {}, None, 0
    for line in library_sass("paged_attention.cu").splitlines():
        m = re.search(r"Function : .*?paged_append_tc_kernelI(f|13__nv_bfloat16|6__half)Lb([01])"
                      r"ELi(\d+)E", line)
        if m:
            name = (f"paged_append_tc_kernel<{forms[m.group(1)]},"
                    f"{'split' if m.group(2) == '1' else 'single'},{m.group(3)}>")
            counts[name] = 0
        elif "Function : " in line:
            name = "simt" if "paged_append_kernel" in line else None
        elif name == "simt" and "HMMA" in line:
            simt_hmma += 1
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    if len(counts) != 18 or not all(counts.values()) or simt_hmma:
        raise AssertionError("paged tensor-core body: expected HMMA in 3 forms x 2 kernels x 3 "
                             f"head dims and none in the CUDA-core body, got {counts or 'none'}, "
                             f"{simt_hmma} in the CUDA-core body")
    return counts


def time_eager_ms(fn, iters: int = 20) -> float:
    """ms per call by CUDA events around ``iters`` eager calls: the
    device's time where the host issues ahead of it, else the host's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int = 20) -> float:
    """Device ms per call: the durations of the GPU kernels and copies
    that torch.profiler records over ``iters`` eager calls, summed (one
    stream, so they do not overlap), for a call a CUDA graph cannot
    capture (autograd's backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device activity")
    return us / 1e3 / iters


def flash_inputs(gen, b, sq, sk, h, d, causal, scale, copies=1, dtype=None):
    """``copies`` sets of (q, k, v, dO, lse, delta) on the card, q, k, v
    and dO in ``dtype`` (float32 by default); lse and delta come from the
    plain forward."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    dtype = dtype or torch.float32
    sets = []
    for _ in range(copies):
        q = torch.randn((b, sq, h, d), generator=gen).to("cuda", dtype)
        k = torch.randn((b, sk, h, d), generator=gen).to("cuda", dtype)
        v = torch.randn((b, sk, h, d), generator=gen).to("cuda", dtype)
        do = torch.randn((b, sq, h, d), generator=gen).to("cuda", dtype)
        o, lse = fa.reference_flash_forward(q, k, v, causal, scale)
        sets.append((q, k, v, do, lse, fa.flash_delta(do, o)))
    return sets


def check_flash(name, sets, causal, scale, body=None, range_case=False):
    """The three kernels against their plain versions on the first set,
    at the fp32 gate or, for bf16 and fp16 inputs, check_half's gate (the
    logsumexp, fp32 in every form, at the fp32 gate). ``body``: the body
    (``fa.BODIES``) the forward, dQ and dK/dV launches must have taken.
    ``range_case``: check_half's ``atol`` is range_atol of each output.
    Returns ({kernel: max abs err}, {kernel: body taken}), keyed as the
    launch counts are."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, lse, delta = sets[0]
    form = FLASH_FORMS[str(q.dtype)[6:]]
    if range_case:
        def close(what, got, want):
            return check_half(what, got, want, range_atol(want))
    else:
        close = check_half if form else check_close
    before = dict(fa.LAUNCHES_BY_BODY)
    o, klse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, causal, scale)
    pdq, pdk, pdv = fa.reference_flash_backward(q, k, v, do, lse, delta, causal, scale)
    took = dict(key.split() for key, n in fa.LAUNCHES_BY_BODY.items() if n > before[key])
    for kernel in ("flash_fwd" + form, "flash_bwd_dq" + form, "flash_bwd_dkv" + form):
        if body is not None and took.get(kernel) != body:
            raise AssertionError(f"{name}: {kernel} took the {took.get(kernel)} body, not {body}")
    return {
        "flash_fwd" + form: max(close(f"{name} forward o", o, po),
                                check_close(f"{name} forward lse", klse, plse)),
        "flash_bwd_dq" + form: close(f"{name} dq", dq, pdq),
        "flash_bwd_dkv" + form: max(close(f"{name} dk", dk, pdk), close(f"{name} dv", dv, pdv)),
    }, took


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary (a view into a larger buffer): no TMA copy takes it."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    return buf[1:1 + t.numel()].view(t.shape).copy_(t)


def check_value_head_dim(seed: int) -> None:
    """multihead attention's core with v's head dim other than q's and
    k's (kdim 8 / vdim 16, and 64 / 24), fp32, bf16 and fp16: the kernels
    run on zero-padded head dims (3 launches a forward and backward) and
    match the plain versions, output and gradients. In bf16 and fp16 the
    padded D = 16 keeps the mma.sync bodies and D = 64 takes the wgmma
    forward, dQ and dK/dV."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 23)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        form = FLASH_FORMS[str(dtype)[6:]]
        for dk, dv in ((8, 16), (64, 24)):
            base = [torch.randn(2, 8, 2, d, generator=gen).to("cuda", dtype) for d in (dk, dk, dv)]
            dout = torch.randn(2, 8, 2, dv, generator=gen).to("cuda", dtype)
            outs = {}
            for backend in ("auto", "plain"):
                q, k, v = (t.clone().requires_grad_(True) for t in base)
                fa.reset_launch_counts()
                o = fa.flash_attention(q, k, v, backend=backend)
                o.backward(dout)
                torch.cuda.synchronize()
                if sum(fa.LAUNCHES.values()) != (3 if backend == "auto" else 0):
                    raise AssertionError(f"Dv != Dk, {backend}: launches {fa.LAUNCHES}")
                if backend == "auto" and form:
                    body = "wgmma" if max(dk, dv) > 32 else "mma_sync"
                    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                        if fa.LAUNCHES_BY_BODY[f"{kernel}{form} {body}"] != 1:
                            raise AssertionError(f"Dk={dk} Dv={dv} {form}: {kernel}{form} not on "
                                                 f"the {body} body ({fa.LAUNCHES_BY_BODY})")
                outs[backend] = (o.detach(), q.grad, k.grad, v.grad)
            close = check_half if form else check_close
            tag = f"flash Dk={dk} Dv={dv} {str(dtype)[6:]}"
            errs = [close(f"{tag} {n}", g, w)
                    for n, g, w in zip(("o", "dq", "dk", "dv"), outs["auto"], outs["plain"])]
            print(f"{tag}: output {tuple(outs['auto'][0].shape)}, max abs err "
                  f"{max(errs):.3e} (o, dq, dk, dv against the plain versions)")


def flash_phase(seed: int):
    """The flash kernels, float32, bf16 and fp16 forms, against their
    plain versions at the training shape and edge shapes (fp16 also where
    its range matters: most of P below 2^-14, dS past 65504, gradients of
    order 1e-6); device times at the training shape and the causal S=512
    shape. Returns per-kernel records (launches filled in by the training
    phase)."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 11)
    rows = {}
    for (label, (b, s, h, d, causal, copies)), dtype in itertools.product({
        "train": (32, 128, 12, 64, False, 3),  # 3 x 50 MB of q/k/v/dO: past the L2
        "causal512": (4, 512, 12, 64, True, 3),
    }.items(), (torch.float32, torch.bfloat16, torch.float16)):
        scale = d ** -0.5
        form = FLASH_FORMS[str(dtype)[6:]]
        sets = flash_inputs(gen, b, s, s, h, d, causal, scale, copies, dtype)
        errs, bodies = check_flash(f"flash {label}{form}", sets, causal, scale,
                                   body="wgmma" if form else "mma_sync")
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in st[:4]) for st in sets]
        for qq, kk, vv, _ in lib_sets:
            for t in (qq, kk, vv):
                t.requires_grad_(True)
        sdpa_fwd, _ = time_ms(
            lambda qq, kk, vv, _do: F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal),
            [tuple(t.detach() for t in st) for st in lib_sets])
        outs = [F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
                for qq, kk, vv, _ in lib_sets]
        calls = itertools.count()

        def sdpa_bwd():
            i = next(calls) % len(lib_sets)
            torch.autograd.grad(outs[i], lib_sets[i][:3], lib_sets[i][3], retain_graph=True)

        # SDPA's backward on the device (autograd cannot be captured into a
        # CUDA graph here): its kernels' durations by torch.profiler; the
        # eager figure (host issue included) is kept beside it
        sdpa_bwd_eager_ms = time_eager_ms(sdpa_bwd)
        sdpa_bwd_ms = profiled_device_ms(sdpa_bwd)
        timed = {
            "flash_fwd" + form: (
                lambda q, k, v, do, lse, de: fa.flash_forward_kernel(q, k, v, causal, scale),
                lambda q, k, v, do, lse, de: fa.reference_flash_forward(q, k, v, causal, scale),
                sdpa_fwd, "fwd"),
            "flash_bwd_dq" + form: (
                lambda *a: fa.flash_backward_dq_kernel(*a, causal, scale),
                lambda *a: fa.reference_flash_backward_dq(*a, causal, scale),
                sdpa_bwd_ms, "dq"),
            "flash_bwd_dkv" + form: (
                lambda *a: fa.flash_backward_dkv_kernel(*a, causal, scale),
                lambda *a: fa.reference_flash_backward_dkv(*a, causal, scale),
                sdpa_bwd_ms, "dkv"),
        }
        shape = {"B": b, "S": s, "H": h, "D": d, "causal": causal, "dtype": str(dtype)[6:]}
        for name, (kern, plain, lib_ms, kind) in timed.items():
            ms, eager_ms = time_ms(kern, sets)
            plain_ms, _ = time_ms(plain, sets)
            bound_ms, bound_by, fp32_bound_ms = flash_bound(kind, b, s, s, h, d, causal,
                                                            bool(form))
            row = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                   "fp32_cuda_core_bound_ms": fp32_bound_ms,
                   "eager_ms": eager_ms, "body": bodies[name], "shape": shape}
            print(f"flash {label} {name}: " + json.dumps(row))
            rows.setdefault(label, {})[name] = row
        print(f"flash {label}{form}: SDPA forward {sdpa_fwd:.4f} ms, backward (dq, dk, dv "
              f"together) {sdpa_bwd_ms:.4f} ms on the device ({sdpa_bwd_eager_ms:.4f} ms eager)")
        del sets, lib_sets, outs
    # edge shapes, correctness only: ragged S with D = 128, Sq != Sk, D = 256
    # (the CUDA-core forward and dK/dV), one query row, a ragged tile past
    # 64 rows, D = 8, head dims past 256 (the 16-row CUDA-core kernels);
    # then the bf16 forms: the kept mma.sync bodies at D % 8 != 0 (element
    # copies), D <= 32 and a misaligned view; the wgmma bodies at Sq != Sk,
    # a ragged S, D = 40 and 96 (padded to 64 and 128), D = 128 and one
    # query row; the CUDA cores at D = 256 and 512; the fp16 forms at a
    # sample of the same
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    mma, wg, simt = "mma_sync", "wgmma", "cuda_cores"
    for b, sq, sk, h, d, causal, dtype, body, offset in [
            (2, 100, 100, 3, 128, False, f32, mma, False),
            (2, 64, 200, 4, 64, False, f32, mma, False),
            (2, 128, 128, 2, 256, False, f32, simt, False), (2, 1, 1, 3, 64, False, f32, mma, False),
            (2, 65, 65, 3, 64, False, f32, mma, False), (2, 65, 65, 3, 64, True, f32, mma, False),
            (2, 128, 128, 2, 8, False, f32, mma, False),
            (2, 96, 96, 2, 512, False, f32, simt, False),
            (2, 65, 65, 2, 512, True, f32, simt, False),
            (2, 40, 40, 2, 300, False, f32, simt, False),
            (2, 70, 70, 3, 33, False, bf16, mma, False), (2, 40, 40, 2, 32, True, bf16, mma, False),
            (2, 96, 96, 2, 64, True, bf16, mma, True),
            (2, 64, 200, 4, 64, False, bf16, wg, False),
            (2, 100, 100, 3, 64, False, bf16, wg, False), (2, 65, 65, 2, 40, True, bf16, wg, False),
            (2, 129, 129, 2, 96, True, bf16, wg, False),
            (2, 200, 200, 2, 128, False, bf16, wg, False), (2, 1, 1, 3, 64, False, bf16, wg, False),
            (2, 65, 65, 3, 256, True, bf16, simt, False),
            (2, 64, 64, 2, 512, False, bf16, simt, False),
            (2, 70, 70, 3, 33, False, f16, mma, False), (2, 96, 96, 2, 64, True, f16, mma, True),
            (2, 64, 200, 4, 64, False, f16, wg, False), (2, 129, 129, 2, 96, True, f16, wg, False),
            (2, 1, 1, 3, 64, False, f16, wg, False), (2, 65, 65, 3, 256, True, f16, simt, False)]:
        sets = flash_inputs(gen, b, sq, sk, h, d, causal, d ** -0.5, dtype=dtype)
        if offset:
            sets = [tuple(misaligned(t) for t in st[:4]) + st[4:] for st in sets]
        tag = (f"Sq={sq} Sk={sk} D={d}" + (" causal" if causal else "") + f" {str(dtype)[6:]}"
               + (" misaligned" if offset else ""))
        errs, bodies = check_flash(f"flash edge {tag}", sets, causal, d ** -0.5, body=body)
        print(f"flash edge B={b} H={h} {tag}: max abs err "
              + json.dumps({k: f"{e:.3e}" for k, e in errs.items()}) + " bodies "
              + json.dumps(bodies))
    check_fp16_range(seed)
    check_value_head_dim(seed)
    torch.cuda.empty_cache()
    return rows


# the fp16 range cases: (name, q, k, v and dO multipliers of randn inputs)
FP16_RANGE_CASES = (("P below 2^-14", (6, 1, 1, 1)),
                    ("dS past 65504", (0.01, 0.01, 1000, 1000)),
                    ("gradients 1e-6", (1, 1, 1, 1e-6)))


def fp16_range_sets(seed: int):
    """Yields (case, (q, k, v, dO, lse, delta), P's share below 2^-14,
    largest |dS|) for each of FP16_RANGE_CASES at B=2 S=128 H=4 D=64 on
    the card, after checking that each case is the range end it names."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 29)
    b, s, h, d = 2, 128, 4, 64
    scale = d ** -0.5
    for case, mul in FP16_RANGE_CASES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen).mul(m).to("cuda", torch.float16)
                       for m in mul)
        o, lse = fa.reference_flash_forward(q, k, v, False, scale)
        delta = fa.flash_delta(do, o)
        _, _, _, p, ds = fa._plain_probs(q, k, v, do, lse, delta, False, scale)
        low, ds_max = float((p < 2.0 ** -14).float().mean()), float(ds.abs().max())
        if ((case == "P below 2^-14" and low <= 0.5)
                or (case == "dS past 65504" and ds_max <= 65504)
                or (case == "gradients 1e-6" and ds_max >= 2.0 ** -14)):
            raise AssertionError(f"fp16 {case}: P below 2^-14 {low:.3f}, max |dS| {ds_max}")
        yield case, (q, k, v, do, lse, delta), low, ds_max


def check_fp16_range(seed: int) -> None:
    """The fp16 forms where fp16's range matters (the cases
    tests/test_torch_port_flash_split_numerics.py emulates): q times 6
    (most of P below 2^-14, so P's halves are subnormal), q and k times
    0.01 with v and dO times 1000 (|dS| past 65504: the wgmma bodies scale
    each row of dS by a power of two before its split), dO times 1e-6 (dS
    and the gradients subnormal in fp16, as training's are: each row of dS
    scaled up). Each on the wgmma bodies, within one fp16 ulp of the plain
    value (no finer than the subnormal spacing) + HALF_RANGE_SHARE of the
    output's largest |value|: a body without the scaling errs by 2
    subnormal ulps in dQ and dK at 1e-6 and is refused
    (``python3 -m flexflow_tpu_torch.tools.flash_probe range``)."""
    scale = 64 ** -0.5
    for case, st, low, ds_max in fp16_range_sets(seed):
        errs, _ = check_flash(f"flash fp16 {case}", [st], False, scale, body="wgmma",
                              range_case=True)
        print(f"flash fp16 {case} (B=2 S=128 H=4 D=64; P below 2^-14 {low:.3f}, max |dS| "
              f"{ds_max:.4g}): max abs err "
              + json.dumps({k_: f"{e:.3e}" for k_, e in errs.items()}))


def bert_base(dtype=None):
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072,
                             seq_length=128, dtype=dtype or DataType.FLOAT)


def kernel_group(name: str) -> str:
    """A device kernel's group in a train step's time: the flash kernels,
    cuBLAS's GEMMs, or elementwise and everything else."""
    if "flash_" in name:
        return "flash kernels"
    if any(k in name for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "GEMMs (cuBLAS)"
    return "elementwise and other"


def training_phase(seed: int, dtype=None):
    """BERT-Base width through FFModel -> compile -> fit on the card, in
    ``dtype``: DataType.FLOAT (the default), BFLOAT16 (``bench.py``'s
    cell) or HALF."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType, MetricsType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import SGDOptimizer

    cfg = bert_base(dtype or DataType.FLOAT)
    batch, warm, steps = 32, 2, 10
    type_name = str(cfg.dtype.torch)[6:]
    form = FLASH_FORMS[type_name]
    tag = {"": "fp32", "_bf16": "bf16", "_f16": "fp16"}[form]
    # the step's flash launches: num_layers of each kernel of its form, none of the others
    per_step = {f"{kernel}{f}": (cfg.num_layers if f == form else 0)
                for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                for f in FLASH_FORMS.values()}
    if set(per_step) != set(fa.LAUNCHES):
        raise AssertionError(f"flash launch counts {sorted(fa.LAUNCHES)}, expected "
                             f"{sorted(per_step)}")
    t0 = time.perf_counter()
    model = build_transformer(FFConfig(batch_size=batch, seed=seed, printing_interval=5), cfg)
    model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
                  metrics=[MetricsType.MEAN_SQUARED_ERROR])
    ex = model.executor
    n_params = sum(p.numel() for g in ex.params.values() for p in g.values())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, cfg.seq_length, cfg.hidden_size)
    x = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    y = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # one step from the same weights, kernel attention vs plain attention
    snap = {k: {n: p.detach().clone() for n, p in g.items()} for k, g in ex.params.items()}

    def restore():
        with torch.no_grad():
            for k, g in ex.params.items():
                for n, p in g.items():
                    p.copy_(snap[k][n])

    after = {}
    for backend in ("auto", "plain"):
        restore()
        ex.backend = backend
        fa.reset_launch_counts()
        loss = float(ex.train_batch([x], y)["loss"])
        launches = dict(fa.LAUNCHES)
        after[backend] = (loss, {k: {n: p.detach().clone() for n, p in g.items()}
                                 for k, g in ex.params.items()})
        want = per_step if backend == "auto" else {name: 0 for name in per_step}
        if launches != want:
            raise AssertionError(f"{tag} {backend} step launched {launches}, expected {want}")
    ex.backend = "auto"
    restore()
    (lk, pk), (lp, pp) = after["auto"], after["plain"]
    leaves = [(k, n) for k in pk for n in pk[k]]
    if any(pk[k][n].dtype != cfg.dtype.torch for k, n in leaves):
        raise AssertionError(f"{tag}: a parameter left {cfg.dtype.torch} in the step")
    param_err = max(float((pk[k][n].float() - pp[k][n].float()).abs().max()) for k, n in leaves)
    moved = max(float((pk[k][n].float() - snap[k][n].float()).abs().max()) for k, n in leaves)
    print(f"training {tag}: one step, kernel vs plain attention: loss {lk:.7f} vs {lp:.7f}, "
          f"params max abs diff {param_err:.3e} (the step moved them by up to {moved:.3e})")
    loss_rtol = HALF_LOSS_RTOL[type_name] if form else LOSS_RTOL
    if not (np.isfinite(lk) and abs(lk - lp) <= loss_rtol * abs(lp)):
        raise AssertionError(f"{tag} train-step loss kernel {lk} vs plain {lp} beyond rtol "
                             f"{loss_rtol}")
    if not 0 < moved:
        raise AssertionError(f"{tag}: the step moved no parameter")
    if form:
        for k, n in leaves:
            a, b_ = pk[k][n].float(), pp[k][n].float()
            lim = 2 * half_ulp(torch.maximum(a.abs(), b_.abs()), cfg.dtype.torch) + (
                HALF_PARAM_SHARE * float((pp[k][n].float() - snap[k][n].float()).abs().max()))
            if ((a - b_).abs() > lim).any():
                raise AssertionError(f"{tag} params {k}.{n} after one step: kernel vs plain "
                                     f"beyond 2 ulps + {HALF_PARAM_SHARE} of the update")
    elif param_err > PARAM_STEP_RTOL * moved:
        raise AssertionError(f"params after one step differ by {param_err}, more than "
                             f"{PARAM_STEP_RTOL} of the step's largest update {moved}")
    del after, snap, pk, pp

    # warm-up, then the timed steps on one random batch (repeated, so the
    # loss of plain gradient descent must fall)
    model.fit(x.repeat(warm, 1, 1), y.repeat(warm, 1, 1), verbose=False)
    xs, ys = x.repeat(steps, 1, 1), y.repeat(steps, 1, 1)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    model.fit(xs, ys, trace_window=1)  # eager steps: the window phase holds graphs against them
    launches = dict(fa.LAUNCHES)
    by_body = {key: n for key, n in fa.LAUNCHES_BY_BODY.items() if n}
    losses = model.step_losses
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"{tag} {name}: {n} launches in {steps} steps, expected "
                                 f"{per_step[name]} per step ({launches})")
    # every 2-byte forward, dQ and dK/dV launch of the cell on the wgmma bodies
    for name in (f"{k}{form}" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if form):
        if by_body.get(f"{name} wgmma", 0) != launches[name]:
            raise AssertionError(f"{tag}: {name} launches by body {by_body}, expected all "
                                 f"{launches[name]} on the wgmma body")
    if any(p.dtype != cfg.dtype.torch for g in ex.params.values() for p in g.values()):
        raise AssertionError(f"{tag}: a parameter left {cfg.dtype.torch} in training")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite or not falling: {losses}")
    elapsed = model.last_elapsed

    # a profiled pair of steps: the device's busy share and time by kernel
    # (the profiler slows the host, so the share is also taken against the
    # unprofiled step's wall)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        model.fit(x.repeat(2, 1, 1), y.repeat(2, 1, 1), verbose=False)
        prof_wall = time.perf_counter() - tp
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # the elementwise group's largest kernels, device us a step, by name
    # (long enough to tell the dtype and the functor apart)
    elementwise = sorted(((name, us / 2) for name, us in by_name.items()
                          if kernel_group(name) == "elementwise and other"),
                         key=lambda kv: -kv[1])[:12]
    groups = {"flash kernels": 0.0, "GEMMs (cuBLAS)": 0.0, "elementwise and other": 0.0}
    for name, us in by_name.items():
        groups[kernel_group(name)] += us / 1e3 / 2
    step_device_ms = busy_us / 1e3 / 2
    stats = {
        "dtype": tag, "layers": cfg.num_layers, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
        "ff": cfg.ff_size, "seq": cfg.seq_length, "batch": batch, "params": n_params,
        "setup_s": setup_s, "warmup_steps": warm, "timed_steps": steps, "elapsed_s": elapsed,
        "step_ms": 1e3 * elapsed / steps, "samples_per_s": steps * batch / elapsed,
        "tokens_per_s": steps * batch * cfg.seq_length / elapsed,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": launches,
        "launches_by_body": by_body,
        "kernel_vs_plain": {"loss_kernel": lk, "loss_plain": lp, "param_max_abs_diff": param_err,
                            "param_max_update": moved},
        "profiled_steps": 2, "profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": (busy_us / 1e6 / prof_wall) if busy_us > 0 else None,
        "step_device_ms": step_device_ms,
        # device time of a profiled step over the unprofiled step's wall
        "device_busy_share_of_timed_step": (
            step_device_ms / (1e3 * elapsed / steps) if busy_us > 0 else None),
        "step_device_ms_by_group": groups,
        "top_device_us": {name[:80]: us for name, us in top},
        "elementwise_step_us_by_kernel": {name[:200]: us for name, us in elementwise},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"training (BERT-Base width, {tag}): " + json.dumps(stats))
    del model, ex, x, y, xs, ys
    torch.cuda.empty_cache()
    return stats


# the full-width heads cells: (TransformerConfig fields, source length or
# None, batch); bert-base-uncased as published, its SST-2 (2-class) and
# masked-LM heads, and Transformer-base (Vaswani et al. 2017: 6 + 6 layers,
# d_model 512, 8 heads, ff 2048, a shared BPE vocabulary of 37000) at
# source 128, target 96
HEADS_CELLS = {
    "bert-cls": (dict(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072, seq_length=128,
                      vocab_size=30522, num_classes=2, dropout=0.1), None, 32),
    "bert-mlm": (dict(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072, seq_length=128,
                      vocab_size=30522, dropout=0.1), None, 32),
    "seq2seq": (dict(num_layers=6, hidden_size=512, num_heads=8, ff_size=2048, seq_length=96,
                     vocab_size=37000, dropout=0.1), 128, 32),
}


def heads_kernel_group(name: str) -> str:
    """kernel_group, with the int64 elementwise kernels (the threefry mask
    draws of the dropout nodes) as a group of their own."""
    group = kernel_group(name)
    if group == "elementwise and other" and re.search(r"\blong\b|int64", name):
        return "dropout masks (int64 threefry)"
    return group


@contextlib.contextmanager
def recorded_masks(store: list, events: list = None):
    """Every dropout mask drawn inside the block appended to ``store``
    (``prng.bernoulli`` wrapped); with ``events``, a CUDA event pair
    around each draw."""
    import torch

    from flexflow_tpu_torch.generation import prng

    draw = prng.bernoulli

    def recording(*a, **kw):
        if events is not None:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        mask = draw(*a, **kw)
        if events is not None:
            end.record()
            events.append((start, end))
        store.append(mask)
        return mask

    prng.bernoulli = recording
    try:
        yield
    finally:
        prng.bernoulli = draw


@contextlib.contextmanager
def flash_by_attention_kind(counts: dict):
    """Count each flash launch inside the block by its kernel and its
    (query length, key length) as well (``fa._count`` wrapped)."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    count = fa._count

    def counting(kernel, form, q, k, *rest):
        key = f"{kernel}{form} Sq={q.shape[1]} Sk={k.shape[1]}"
        counts[key] = counts.get(key, 0) + 1
        return count(kernel, form, q, k, *rest)

    fa._count = counting
    try:
        yield
    finally:
        fa._count = count


def heads_inputs(kind: str, cfg, src_len, batch: int, gen):
    """One batch on the card: int32 tokens (or fp32 source and target
    embeddings for seq2seq) and int32 labels."""
    import torch

    dev = "cuda"
    if kind == "seq2seq":
        xs = [torch.randn((batch, src_len, cfg.hidden_size), generator=gen, device=dev),
              torch.randn((batch, cfg.seq_length, cfg.hidden_size), generator=gen, device=dev)]
        y = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_length), generator=gen, device=dev)
        return xs, y.int()
    xs = [torch.randint(0, cfg.vocab_size, (batch, cfg.seq_length), generator=gen,
                        device=dev).int()]
    if kind == "bert-cls":
        return xs, torch.randint(0, 2, (batch, 1), generator=gen, device=dev).int()
    return xs, torch.randint(0, cfg.vocab_size, (batch, cfg.seq_length), generator=gen,
                             device=dev).int()


def heads_phase(seed: int, kind: str, dtype=None, steps: int = 10) -> tuple:
    """One heads cell through FFModel -> compile (SGD lr 0.01, sparse
    categorical cross-entropy, accuracy) -> fit on the card, dropout 0.1:
    one step with the kernels and one with plain attention from the same
    weights and step key (masks bit-identical, the training gates), then
    warm-up and ``steps`` timed steps (flash launches a step, a falling
    loss without dropout), a profiled pair and the masks' device ms.
    Returns (stats, model, one batch)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType, MetricsType
    from flexflow_tpu_torch.generation import prng
    from flexflow_tpu_torch.models import TransformerConfig, build_transformer
    from flexflow_tpu_torch.models import build_transformer_seq2seq
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import SGDOptimizer

    fields, src_len, batch = HEADS_CELLS[kind]
    cfg = TransformerConfig(**fields, dtype=dtype or DataType.FLOAT)
    type_name = str(cfg.dtype.torch)[6:]
    form = FLASH_FORMS[type_name]
    tag = f"{kind} {'fp32' if not form else type_name}"
    layers = cfg.num_layers * (3 if kind == "seq2seq" else 1)  # + decoder self and cross
    per_step = {f"{kernel}{f}": (layers if f == form else 0)
                for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                for f in FLASH_FORMS.values()}
    t0 = time.perf_counter()
    config = FFConfig(batch_size=batch, seed=seed, printing_interval=5)
    if kind == "seq2seq":
        model = build_transformer_seq2seq(config, cfg, src_seq_length=src_len)
    else:
        model = build_transformer(config, cfg)
    model.compile(optimizer=SGDOptimizer(lr=0.01),
                  loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.ACCURACY])
    ex = model.executor
    n_params = sum(p.numel() for g in ex.params.values() for p in g.values())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs, y = heads_inputs(kind, cfg, src_len, batch, gen)
    key = tuple(t.cuda() for t in prng.split(prng.key(seed))[1])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # one step from the same weights and key, kernel vs plain attention
    snap = {k: {n: p.detach().clone() for n, p in g.items()} for k, g in ex.params.items()}

    def restore():
        with torch.no_grad():
            for k, g in ex.params.items():
                for n, p in g.items():
                    p.copy_(snap[k][n])

    after, masks = {}, {}
    for backend in ("auto", "plain"):
        restore()
        ex.backend = backend
        fa.reset_launch_counts()
        masks[backend] = []
        with recorded_masks(masks[backend]):
            loss = float(ex.train_batch(xs, y, rng=key)["loss"])
        launches = dict(fa.LAUNCHES)
        after[backend] = (loss, {k: {n: p.detach().clone() for n, p in g.items()}
                                 for k, g in ex.params.items()})
        want = per_step if backend == "auto" else {name: 0 for name in per_step}
        if launches != want:
            raise AssertionError(f"{tag} {backend} step launched {launches}, expected {want}")
    ex.backend = "auto"
    restore()
    # an attention and an FFN dropout an encoder block; a decoder block's
    # self-attention, cross-attention and FFN
    n_drop = cfg.num_layers * (5 if kind == "seq2seq" else 2)
    if len(masks["auto"]) != n_drop or len(masks["plain"]) != n_drop:
        raise AssertionError(f"{tag}: {len(masks['auto'])} / {len(masks['plain'])} masks drawn, "
                             f"expected {n_drop}")
    if not all(torch.equal(a, b) for a, b in zip(masks["auto"], masks["plain"])):
        raise AssertionError(f"{tag}: the dropout masks differ between the kernel and plain steps")
    mask_elems = sum(m.numel() for m in masks["auto"])
    keep_share = sum(int(m.sum()) for m in masks["auto"]) / mask_elems
    if not 0.895 < keep_share < 0.905:
        raise AssertionError(f"{tag}: masks keep {keep_share:.4f} of their elements, not ~0.9")
    del masks
    (lk, pk), (lp, pp) = after["auto"], after["plain"]
    leaves = [(k, n) for k in pk for n in pk[k]]
    param_err = max(float((pk[k][n].float() - pp[k][n].float()).abs().max()) for k, n in leaves)
    moved = max(float((pk[k][n].float() - snap[k][n].float()).abs().max()) for k, n in leaves)
    print(f"{tag}: one step, kernel vs plain attention, the same {n_drop} dropout masks: loss "
          f"{lk:.7f} vs {lp:.7f}, params max abs diff {param_err:.3e} (moved up to {moved:.3e})")
    loss_rtol = HALF_LOSS_RTOL[type_name] if form else LOSS_RTOL
    if not (np.isfinite(lk) and abs(lk - lp) <= loss_rtol * abs(lp)):
        raise AssertionError(f"{tag} loss kernel {lk} vs plain {lp} beyond rtol {loss_rtol}")
    if not 0 < moved:
        raise AssertionError(f"{tag}: the step moved no parameter")
    if any(pk[k][n].dtype != cfg.dtype.torch for k, n in leaves):
        raise AssertionError(f"{tag}: a parameter left {cfg.dtype.torch} in the step")
    if form:
        for k, n in leaves:
            a, b_ = pk[k][n].float(), pp[k][n].float()
            lim = 2 * half_ulp(torch.maximum(a.abs(), b_.abs()), cfg.dtype.torch) + (
                HALF_PARAM_SHARE * float((pp[k][n].float() - snap[k][n].float()).abs().max()))
            if ((a - b_).abs() > lim).any():
                raise AssertionError(f"{tag} params {k}.{n}: kernel vs plain beyond 2 ulps + "
                                     f"{HALF_PARAM_SHARE} of the update")
    elif param_err > PARAM_STEP_RTOL * moved:
        raise AssertionError(f"{tag} params differ by {param_err}, more than {PARAM_STEP_RTOL} "
                             f"of the step's largest update {moved}")
    del after, snap, pk, pp

    # the loss without dropout before and after training on the batch
    eval_before = float(ex.eval_batch(xs, y)["loss"])
    warm = 2
    model.fit([x.repeat(warm, *([1] * (x.dim() - 1))) for x in xs],
              y.repeat(warm, 1), verbose=False)
    rep = [x.repeat(steps, *([1] * (x.dim() - 1))) for x in xs]
    ys = y.repeat(steps, 1)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    by_kind = {}
    with flash_by_attention_kind(by_kind):
        model.fit(rep, ys, trace_window=1)  # eager steps, as the training phase
    launches = dict(fa.LAUNCHES)
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"{tag} {name}: {n} launches in {steps} steps, expected "
                                 f"{per_step[name]} a step ({launches})")
    by_body = {k_: n for k_, n in fa.LAUNCHES_BY_BODY.items() if n}
    for name in (f"{k_}{form}" for k_ in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if form):
        if by_body.get(f"{name} wgmma", 0) != launches[name]:
            raise AssertionError(f"{tag}: {name} launches by body {by_body}, expected all "
                                 f"{launches[name]} on the wgmma body")
    eval_after = float(ex.eval_batch(xs, y)["loss"])
    losses = model.step_losses
    if not (all(np.isfinite(losses)) and np.isfinite(eval_after) and eval_after < eval_before):
        raise AssertionError(f"{tag}: losses not finite or not falling (without dropout "
                             f"{eval_before} -> {eval_after}; steps {losses})")
    elapsed = model.last_elapsed

    # the masks' device time (CUDA events around each draw) in one step
    events = []
    with recorded_masks([], events):
        model.fit([x[:batch] for x in rep], ys[:batch], verbose=False)
    torch.cuda.synchronize()
    mask_ms = sum(a.elapsed_time(b) for a, b in events)
    # a profiled pair of steps: device time by kernel group
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        model.fit([x[:2 * batch] for x in rep], ys[:2 * batch], verbose=False)
        prof_wall = time.perf_counter() - tp
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    groups = {}
    for name, us in by_name.items():
        g = heads_kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / 2
    step_device_ms = sum(by_name.values()) / 1e3 / 2
    stats = {
        "cell": kind, "dtype": "fp32" if not form else type_name, **fields,
        "source_length": src_len, "batch": batch, "params": n_params, "setup_s": setup_s,
        "warmup_steps": warm, "timed_steps": steps, "elapsed_s": elapsed,
        "step_ms": 1e3 * elapsed / steps, "samples_per_s": steps * batch / elapsed,
        "loss_steps": losses, "loss_without_dropout": [eval_before, eval_after],
        "launches": launches, "launches_by_body": by_body,
        "flash_launches_by_attention_kind": by_kind,
        "kernel_vs_plain": {"loss_kernel": lk, "loss_plain": lp, "param_max_abs_diff": param_err,
                            "param_max_update": moved, "masks": n_drop,
                            "mask_elements": mask_elems, "keep_share": keep_share},
        "dropout_mask_ms_per_step_cuda_events": mask_ms,
        "profiled_wall_s": prof_wall, "step_device_ms": step_device_ms,
        "step_device_ms_by_group": groups,
        "device_busy_share_of_timed_step": step_device_ms / (1e3 * elapsed / steps),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"heads {tag}: " + json.dumps(stats))
    return stats, model, (xs, y)


def infer_post(base: str, name: str, rows, input_name: str = "tokens") -> dict:
    """One POST /v2/models/{name}/infer of int32 token rows: the first
    output array (``out``), every output (``outs``) and the client's
    latency."""
    import urllib.request

    import numpy as np

    body = {"inputs": [{"name": input_name, "shape": list(rows.shape), "datatype": "INT32",
                        "data": rows.reshape(-1).tolist()}]}
    req = urllib.request.Request(f"{base}/v2/models/{name}/infer", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        resp = json.loads(r.read())
    outs = [np.asarray(o["data"], np.float32).reshape(o["shape"]) for o in resp["outputs"]]
    return {"out": outs[0], "outs": outs, "latency_s": time.perf_counter() - t0}


def infer_phase(seed: int, model) -> dict:
    """bert-cls's fp32 model after its fit, saved with ``save_model`` to a
    temporary repository, loaded by an ``InferenceServer`` through
    ``POST /v2/repository/models/bert_sst2/load`` and served over
    ``/v2/models/bert_sst2/infer`` (KServe v2 JSON) to 16 client threads
    posting 64 requests of 1-4 rows; then unloaded."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.serving import (InferenceModel, InferenceServer, ModelRepository,
                                            save_model)

    name, clients, requests = "bert_sst2", 16, 64
    rs = np.random.RandomState(seed)
    vocab, seq = HEADS_CELLS["bert-cls"][0]["vocab_size"], HEADS_CELLS["bert-cls"][0]["seq_length"]
    bodies = [rs.randint(0, vocab, (int(rs.randint(1, 5)), seq)).astype(np.int32)
              for _ in range(requests)]
    results = [None] * requests
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        save_model(InferenceModel(model, name=name, max_batch=32), root)
        save_s = time.perf_counter() - t0
        server = InferenceServer(port=0, repository=ModelRepository(root))
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"

            def post(path):
                req = urllib.request.Request(base + path, data=b"{}", method="POST")
                with urllib.request.urlopen(req, timeout=600) as r:
                    return json.loads(r.read())

            t0 = time.perf_counter()
            if post(f"/v2/repository/models/{name}/load")["state"] != "READY":
                raise AssertionError("infer: the repository load did not report READY")
            load_s = time.perf_counter() - t0
            im = server.models[name]
            if im.max_batch != 32:
                raise AssertionError(f"infer: max_batch {im.max_batch}, expected 32")
            infer_post(base, name, bodies[0][:1])  # warm-up, not counted
            batcher = server.batchers[name]
            calls0, batched0 = batcher.device_calls, batcher.batched_requests
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            lock = threading.Lock()
            todo = list(range(requests))

            def client():
                while True:
                    with lock:
                        if not todo:
                            return
                        i = todo.pop(0)
                    results[i] = infer_post(base, name, bodies[i])

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client) for _ in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads) or any(r is None for r in results):
                raise AssertionError("infer: a client did not finish")
            launches = dict(fa.LAUNCHES)
            calls = batcher.device_calls - calls0
            batched = batcher.batched_requests - batched0
            metrics = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
            stats = server.stats()["models"][name]
            # the same rows through predict on the trained model (its
            # graph's batch: the CLS head reshapes to [32, hidden])
            errs = []
            for rows, res in zip(bodies, results):
                padded = np.zeros((32, seq), np.int32)
                padded[:len(rows)] = rows
                want = model.predict(torch.from_numpy(padded).cuda()).float().cpu().numpy()
                want = want[:len(rows)]
                got = res["out"]
                if got.shape != want.shape or not np.array_equal(got.argmax(-1), want.argmax(-1)):
                    raise AssertionError(f"infer: response {got} vs predict {want}")
                errs.append(float(np.abs(got - want).max()))
            post(f"/v2/repository/models/{name}/unload")
            try:
                urllib.request.urlopen(f"{base}/v2/models/{name}/ready", timeout=60)
                ready_after = True
            except urllib.error.HTTPError as e:
                ready_after = e.code == 200
        finally:
            server.stop()
    validate_exposition(metrics)
    completed = re.search(r'flexflow_serving_requests_total\{model="%s",outcome="completed"\} '
                          r"(\d+)" % name, metrics)
    want_launches = {k: 0 for k in launches}
    want_launches["flash_fwd"] = HEADS_CELLS["bert-cls"][0]["num_layers"] * calls
    lat = sorted(r["latency_s"] for r in results)
    out = {
        "clients": clients, "requests": requests, "rows": sum(len(b) for b in bodies),
        "save_s": save_s, "load_s": load_s, "wall_s": wall, "requests_per_s": requests / wall,
        "rows_per_s": sum(len(b) for b in bodies) / wall,
        "latency_p50_s": lat[len(lat) // 2], "latency_p99_s": lat[min(len(lat) - 1,
                                                                                                  int(0.99 * len(lat)))],
        "device_batches": calls, "requests_per_device_batch": batched / max(1, calls),
        "launches": launches, "max_abs_err_vs_predict": max(errs),
        "metrics_completed": int(completed.group(1)) if completed else None,
        "stats_completed": stats["completed"], "ready_after_unload": ready_after,
    }
    print("infer (bert_sst2 over /v2/models/{name}/infer): " + json.dumps(out))
    if max(errs) > 1e-5:
        raise AssertionError(f"infer: responses differ from predict by {max(errs)} > 1e-5")
    if not out["requests_per_device_batch"] > 1:
        raise AssertionError(f"infer: {out['requests_per_device_batch']} requests a device batch")
    if launches != want_launches:
        raise AssertionError(f"infer: flash launches {launches}, expected {want_launches} "
                             f"(12 forward launches per device batch)")
    if out["metrics_completed"] != requests + 1 or stats["completed"] != requests + 1:
        raise AssertionError(f"infer: /metrics counts {out['metrics_completed']} completed, "
                             f"the clients received {requests} + 1 warm-up")
    if ready_after:
        raise AssertionError("infer: the model reads ready after its unload")
    return out


def params_copy(tree) -> dict:
    """A detached copy of a ``{node key: {name: tensor}}`` tree."""
    return {k: {n: t.detach().clone() for n, t in g.items()} for k, g in tree.items()}


def load_tree(dst, src) -> None:
    """Copy ``src`` into the tensors of ``dst`` (the same keys), in place."""
    import torch

    with torch.no_grad():
        for k, g in dst.items():
            for n, t in g.items():
                t.copy_(src[k][n])


def step_gates(tag: str, dtype, before, a, b, loss_a: float, loss_b: float,
               loss_rtol=None) -> dict:
    """One training step two ways (``a`` the reference, ``b`` the other),
    from the weights ``before``: the training phase's gates (fp32: loss
    rtol 1e-5 unless ``loss_rtol``, parameters within PARAM_STEP_RTOL of
    the step's largest update; 2-byte: loss within the type's roundoff,
    each parameter within 2 ulps + HALF_PARAM_SHARE of its tensor's
    update). Returns the differences and whether they are bitwise equal."""
    import numpy as np
    import torch

    type_name = str(dtype)[6:]
    half = type_name in HALF_BITS
    leaves = [(k, n) for k in a for n in a[k]]
    moved = max(float((a[k][n].float() - before[k][n].float()).abs().max()) for k, n in leaves)
    err = max(float((a[k][n].float() - b[k][n].float()).abs().max()) for k, n in leaves)
    rtol = HALF_LOSS_RTOL[type_name] if half else (loss_rtol or LOSS_RTOL)
    if not (np.isfinite(loss_b) and abs(loss_b - loss_a) <= rtol * abs(loss_a)):
        raise AssertionError(f"{tag}: loss {loss_b} vs {loss_a} beyond rtol {rtol}")
    if not 0 < moved:
        raise AssertionError(f"{tag}: the step moved no parameter")
    if half:
        for k, n in leaves:
            x, y = a[k][n].float(), b[k][n].float()
            lim = 2 * half_ulp(torch.maximum(x.abs(), y.abs()), dtype) + HALF_PARAM_SHARE * float(
                (x - before[k][n].float()).abs().max())
            if ((x - y).abs() > lim).any():
                raise AssertionError(f"{tag}: {k}.{n} beyond 2 ulps + {HALF_PARAM_SHARE} of "
                                     "the update")
    elif err > PARAM_STEP_RTOL * moved:
        raise AssertionError(f"{tag}: parameters differ by {err}, more than {PARAM_STEP_RTOL} "
                             f"of the step's largest update {moved}")
    bitwise = loss_a == loss_b and all(torch.equal(a[k][n], b[k][n]) for k, n in leaves)
    return {"loss_a": loss_a, "loss_b": loss_b, "param_max_abs_diff": err,
            "param_max_update": moved, "bitwise_equal": bitwise}


def measured_step(ex, inputs, label, key) -> tuple:
    """One ``train_batch``: (loss, host ms, peak device bytes over the
    step, device bytes allocated before it)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(ex.train_batch(inputs, label, rng=key)["loss"])
    torch.cuda.synchronize()
    return loss, 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated(), base


def busy_share(fn) -> tuple:
    """(wall s, device busy s) of ``fn()`` under torch.profiler: the
    durations of its GPU kernels and copies, summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device activity")
    return wall, us / 1e6


def trainer_phase(seed: int, dtype=None) -> dict:
    """A real job's trainer at BERT-Base width (12 x 768, 12 heads, ff
    3072, seq 128, batch 32, SGD lr 0.01, MSE) in ``dtype``: remat on
    against off and ``grad_accum_steps=4`` against 1 from the same weights
    and step key (gates, launches, peak memory, step ms), then the
    DataLoader feeding 8 shuffled batches against pre-staged ones."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType, MetricsType
    from flexflow_tpu_torch.generation import prng
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import SGDOptimizer

    cfg = bert_base(dtype or DataType.FLOAT)
    batch, layers = 32, cfg.num_layers
    form = FLASH_FORMS[str(cfg.dtype.torch)[6:]]
    tag = {"": "fp32", "_bf16": "bf16", "_f16": "fp16"}[form]
    t_phase = time.perf_counter()

    def compiled(graph=None, **kw):
        conf = FFConfig(batch_size=batch, seed=seed, **kw)
        m = (build_transformer(conf, cfg) if graph is None
             else FFModel.from_graph(graph, conf))
        return m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
                         metrics=[MetricsType.MEAN_SQUARED_ERROR])

    plain = compiled()
    remat = compiled(plain.graph, remat_blocks=True)
    accum = compiled(plain.graph, grad_accum_steps=4)
    blocks = remat.executor._remat_plan[1]
    if len(blocks) != layers:
        raise AssertionError(f"{tag}: remat found {len(blocks)} blocks, expected {layers}")
    snap = params_copy(plain.executor.params)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    shape = (batch, cfg.seq_length, cfg.hidden_size)
    x = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    y = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    key = tuple(t.cuda() for t in prng.split(prng.key(seed + 9))[1])

    def per_step(fwd):
        return {f"{k}{f}": (n if f == form else 0)
                for k, n in (("flash_fwd", fwd), ("flash_bwd_dq", layers),
                             ("flash_bwd_dkv", layers))
                for f in FLASH_FORMS.values()}

    want = {"plain": per_step(layers), "remat": per_step(2 * layers),
            "accum": {k: 4 * n for k, n in per_step(layers).items()}}
    models = {"plain": plain, "remat": remat, "accum": accum}
    runs = {name: [] for name in models}
    after = {}
    launches = {name: {k: 0 for k in want["plain"]} for name in models}
    # warm-up once each, then in turns: plain, remat, accum, accum, remat, plain
    order = ["plain", "remat", "accum", "plain", "remat", "accum", "accum", "remat", "plain"]
    for i, name in enumerate(order):
        ex = models[name].executor
        load_tree(ex.params, snap)
        fa.reset_launch_counts()
        loss, ms, peak, base = measured_step(ex, [x], y, key)
        got = dict(fa.LAUNCHES)
        if got != want[name]:
            raise AssertionError(f"trainer {tag} {name}: a step launched {got}, expected "
                                 f"{want[name]}")
        for k, n in got.items():
            launches[name][k] += n
        if i >= len(models):  # the warm-up steps are not timed
            runs[name].append({"loss": loss, "ms": ms, "peak_bytes": peak,
                               "peak_over_before_bytes": peak - base})
        if name not in after:
            after[name] = (loss, params_copy(ex.params))
    gates = {
        "remat": step_gates(f"trainer {tag} remat vs plain", cfg.dtype.torch, snap,
                            after["plain"][1], after["remat"][1], after["plain"][0],
                            after["remat"][0]),
        "accum": step_gates(f"trainer {tag} accumulation 4 vs 1", cfg.dtype.torch, snap,
                            after["plain"][1], after["accum"][1], after["plain"][0],
                            after["accum"][0]),
    }
    del after
    for name in ("remat", "accum"):
        if max(r["peak_bytes"] for r in runs[name]) >= min(r["peak_bytes"] for r in runs["plain"]):
            raise AssertionError(f"trainer {tag}: {name}'s peak memory "
                                 f"{[r['peak_bytes'] for r in runs[name]]} is not below the "
                                 f"plain step's {[r['peak_bytes'] for r in runs['plain']]}")
    for m in (remat, accum):
        del m.executor
    del remat, accum, models
    torch.cuda.empty_cache()

    # the DataLoader: 8 shuffled batches from host memory into train_batch,
    # against the same batches staged on the card first (in turns)
    n = 8 * batch
    rs = np.random.RandomState(seed + 3)
    hx = torch.from_numpy(rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32))
    hy = torch.from_numpy(rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32))
    hx, hy = hx.to(cfg.dtype.torch), hy.to(cfg.dtype.torch)
    loader = plain.create_data_loader(hx, hy, batch_size=batch, shuffle=True, seed=seed)
    order = [np.random.RandomState(seed + e).permutation(n) for e in range(3)]
    ex = plain.executor

    def from_loader():
        return [float(ex.train_batch(ins, lab, rng=key)["loss"]) for ins, lab in loader.epoch()]

    def staged(epoch):
        """The loader's ``epoch`` (its permutation), staged on the card."""
        idx = [torch.from_numpy(order[epoch][i * batch:(i + 1) * batch]) for i in range(8)]
        bx = [hx[i].cuda() for i in idx]
        by = [hy[i].cuda() for i in idx]
        torch.cuda.synchronize()
        return lambda: [float(ex.train_batch([a], b, rng=key)["loss"]) for a, b in zip(bx, by)]

    fa.reset_launch_counts()
    dl = {"loader": [], "staged": []}
    # in turns: the loader's epoch 0, staged epoch 0, staged epoch 1, the loader's epoch 1
    for name, epoch in (("loader", 0), ("staged", 0), ("staged", 1), ("loader", 1)):
        load_tree(ex.params, snap)
        fn = from_loader if name == "loader" else staged(epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = fn()
        torch.cuda.synchronize()
        dl[name].append({"epoch": epoch, "ms_per_step": 1e3 * (time.perf_counter() - t0) / 8,
                         "losses": losses})
    # an epoch's batches give the same losses from either source
    loss_rtol = HALF_LOSS_RTOL.get(str(cfg.dtype.torch)[6:], LOSS_RTOL)
    for a, b in zip(dl["loader"], dl["staged"]):
        if not all(abs(u - v) <= loss_rtol * abs(v) for u, v in zip(a["losses"], b["losses"])):
            raise AssertionError(f"trainer {tag}: the loader's batches gave other losses than "
                                 f"the staged ones: {a['losses']} vs {b['losses']}")
        a["losses_bitwise_equal_to_staged"] = a["losses"] == b["losses"]
    for name in ("loader", "staged"):  # the loader's epoch 2, the same batches staged
        load_tree(ex.params, snap)
        wall, busy = busy_share(from_loader if name == "loader" else staged(2))
        dl[f"{name}_profiled"] = {"wall_s": wall, "device_busy_s": busy,
                                  "device_busy_share": busy / wall}
    launches["dataloader"] = dict(fa.LAUNCHES)
    del plain, ex, loader, x, y
    torch.cuda.empty_cache()
    out = {"dtype": tag, "layers": layers, "batch": batch, "runs": runs, "gates": gates,
           "launches": launches, "dataloader": dl, "phase_s": time.perf_counter() - t_phase}
    print(f"trainer ({tag}): " + json.dumps(out))
    return out


def trainer_resume_data(seed: int, steps: int = 4):
    """The resume cell's batches and step keys, made on the host from
    ``seed`` (the same in the parent and in the resuming child): bert-cls
    at full width, batch 32."""
    import numpy as np

    from flexflow_tpu_torch.generation import prng

    kw, _, batch = HEADS_CELLS["bert-cls"]
    rs = np.random.RandomState(seed + 13)
    x = rs.randint(0, kw["vocab_size"], (steps * batch, kw["seq_length"])).astype(np.int32)
    y = rs.randint(0, kw["num_classes"], (steps * batch, 1)).astype(np.int32)
    keys = prng.split(prng.key(seed + 17), steps)
    return batch, [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch], keys[i])
                   for i in range(steps)]


def resume_model(seed: int, graph_json: str):
    """bert-cls over the saved graph (its guids, so its dropout masks),
    compiled as the resume cell trains it."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.graph import PCGraph
    from flexflow_tpu_torch.core.types import LossType, MetricsType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import SGDOptimizer

    _, _, batch = HEADS_CELLS["bert-cls"]
    m = FFModel.from_graph(PCGraph.from_json(graph_json), FFConfig(batch_size=batch, seed=seed))
    return m.compile(optimizer=SGDOptimizer(lr=0.01),
                     loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                     metrics=[MetricsType.ACCURACY])


def resume_child(seed: int, ckpt_dir: str) -> int:
    """The resuming process of the checkpoint cell (``chip_smoke.py
    --resume-child DIR``): rebuilds bert-cls from DIR's graph, restores
    the newest checkpoint, runs steps 3-4 and writes their losses and the
    final parameters to DIR/resumed.pt."""
    import torch

    from flexflow_tpu_torch.runtime import CheckpointManager

    with open(os.path.join(ckpt_dir, "graph.json")) as f:
        model = resume_model(seed, f.read())
    step = CheckpointManager(os.path.join(ckpt_dir, "ckpt"), max_to_keep=2).restore_latest(
        model.executor)
    _, data = trainer_resume_data(seed)
    losses = [float(model.executor.train_batch([x], y, rng=tuple(k.cuda() for k in key))["loss"])
              for x, y, key in data[step:]]
    torch.save({"step": step, "losses": losses,
                "params": {k: {n: p.detach().cpu() for n, p in g.items()}
                           for k, g in model.executor.params.items()}},
               os.path.join(ckpt_dir, "resumed.pt"))
    return 0


def checkpoint_phase(seed: int) -> dict:
    """bert-cls at full width with dropout 0.1 trains 4 steps on explicit
    keys; ``CheckpointManager(max_to_keep=2)`` saves after steps 1 and 2;
    a fresh process rebuilds the model from its graph, restores the newest
    and runs steps 3-4, whose losses and final parameters must equal the
    uninterrupted run's bit for bit. Then a corrupted newest falls back to
    step 1, and a ``checkpoint.save`` fault leaves no step dir."""
    import shutil
    import tempfile

    import torch

    from flexflow_tpu_torch.models import TransformerConfig, build_transformer
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import CheckpointManager
    from flexflow_tpu_torch.runtime.faults import FaultInjected, FaultPlan

    t_phase = time.perf_counter()
    kw, _, batch = HEADS_CELLS["bert-cls"]
    root = tempfile.mkdtemp(prefix="ff_ckpt_")
    try:
        graph_json = build_transformer(FFConfig(batch_size=batch, seed=seed),
                                       TransformerConfig(**kw)).graph.to_json()
        with open(os.path.join(root, "graph.json"), "w") as f:
            f.write(graph_json)
        model = resume_model(seed, graph_json)
        ex = model.executor
        mgr = CheckpointManager(os.path.join(root, "ckpt"), max_to_keep=2)
        _, data = trainer_resume_data(seed)
        fa.reset_launch_counts()
        losses, save_s, step1 = [], [], None
        for i, (x, y, key) in enumerate(data):
            losses.append(float(ex.train_batch([x], y, rng=tuple(k.cuda() for k in key))["loss"]))
            if i < 2:
                t0 = time.perf_counter()
                mgr.save(ex, i + 1)
                save_s.append(time.perf_counter() - t0)
            if i == 0:
                step1 = params_copy(ex.params)
        launches = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--resume-child", root], capture_output=True, text=True,
                              timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"resume child failed ({proc.returncode}): {proc.stderr[-3000:]}")
        resumed = torch.load(os.path.join(root, "resumed.pt"), weights_only=True)
        if resumed["step"] != 2 or resumed["losses"] != losses[2:]:
            raise AssertionError(f"resumed from step {resumed['step']} with losses "
                                 f"{resumed['losses']}, the uninterrupted run {losses[2:]}")
        diff = [f"{k}.{n}" for k, g in ex.params.items() for n, p in g.items()
                if not torch.equal(p.detach().cpu(), resumed["params"][k][n])]
        if diff:
            raise AssertionError(f"resumed parameters differ from the uninterrupted run's: "
                                 f"{diff[:5]}")
        # a torn newest (cut to half its bytes): restore_latest falls back to step 1
        torn = os.path.join(root, "ckpt", "step_2", "train_state.pt")
        os.truncate(torn, os.path.getsize(torn) // 2)
        back = mgr.restore_latest(ex)
        if back != 1 or any(not torch.equal(p, step1[k][n]) for k, g in ex.params.items()
                            for n, p in g.items()):
            raise AssertionError(f"a corrupt newest restored step {back}, not step 1's weights")
        with FaultPlan().on("checkpoint.save", mode="error").active():
            try:
                mgr.save(ex, 3)
                raise AssertionError("the checkpoint.save fault did not fire")
            except FaultInjected:
                pass
        left = sorted(os.listdir(mgr.directory))
        if left != ["step_1", "step_2"]:
            raise AssertionError(f"after a failed save the checkpoint dir holds {left}")
        ckpt_bytes = os.path.getsize(os.path.join(root, "ckpt", "step_1", "train_state.pt"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, ex, step1
    torch.cuda.empty_cache()
    out = {"losses": losses, "resumed_losses": resumed["losses"], "bitwise_equal": True,
           "save_s": save_s, "checkpoint_bytes": ckpt_bytes, "child_s": child_s,
           "fallback_step": back, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print("trainer checkpoint (bert-cls fp32, dropout 0.1): " + json.dumps(out))
    return out


def sgd_first_step_f64(graph, params, state, x, y, lr: float) -> dict:
    """SGD's first step (-lr * grad; sparse categorical cross-entropy) of
    ``graph`` from ``params`` and ``state`` (by node key), run in float64
    on the CPU: the graph with every float32 tensor made float64."""
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.graph import PCGraph
    from flexflow_tpu_torch.core.types import CompMode
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import losses

    g64 = PCGraph.from_json(graph.to_json().replace('"float32"', '"float64"'))
    m = FFModel.from_graph(g64, FFConfig(batch_size=x.shape[0]), device="cpu")
    ex = m.compile(comp_mode=CompMode.INFERENCE).executor
    load_tree(ex.params, params)
    load_tree(ex.state, state)
    with torch.enable_grad():
        final = ex._forward_impl(ex.params, ex.state, [torch.from_numpy(x).double()],
                                 training=True)[0][-1]
        losses.sparse_categorical_crossentropy(final, torch.from_numpy(y)).backward()
    return {k: {n: -lr * t.grad for n, t in g.items()} for k, g in ex.params.items()}


def vision_kernel_group(name: str) -> str:
    """A device kernel's group in a CNN step: cuDNN's convolutions,
    BatchNorm and elementwise, GEMMs, or other (pooling, softmax, copies)."""
    low = name.lower()
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd",
                              "implicit", "im2col", "col2im")):
        return "convolution"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "GEMM"
    if any(k in low for k in ("pool", "softmax", "memcpy", "memset")):
        return "other"
    return "BatchNorm and elementwise"


def vision_phase(seed: int) -> dict:
    """ResNet-50 at its published ImageNet width (3 x 224 x 224, 1000
    classes, batch 32, fp32; SGD lr 0.01, momentum 0.9, sparse categorical
    cross-entropy, accuracy): one step at batch 4 on the card against the
    port on the CPU from the same weights; warm-up and 10 timed steps at
    batch 32 (images/s, busy share, device ms by kernel group, peak
    memory); the same step with remat (stage 3's 5 blocks) against
    without; eval against the CPU's; one forward of AlexNet, ResNeXt-50
    and Inception-v3 at batch 8."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import CompMode, LossType, MetricsType, OpType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.models import (build_alexnet, build_inception_v3, build_resnet50,
                                           build_resnext50)
    from flexflow_tpu_torch.runtime import SGDOptimizer

    t_phase = time.perf_counter()
    classes, hw = 1000, 224

    def compiled(m):
        return m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
                         loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                         metrics=[MetricsType.ACCURACY])

    def images(n, s):
        rs = np.random.RandomState(s)
        return (rs.randn(n, 3, hw, hw).astype(np.float32),
                rs.randint(0, classes, (n,)).astype(np.int32))

    # --- the card against the CPU, one step at batch 4
    card = compiled(build_resnet50(FFConfig(batch_size=4, seed=seed), classes, hw))
    host = compiled(FFModel.from_graph(card.graph, FFConfig(batch_size=4, seed=seed),
                                       device="cpu"))
    for tree in ("params", "state"):
        load_tree(getattr(host.executor, tree), getattr(card.executor, tree))
    before_p, snap_s4 = params_copy(host.executor.params), params_copy(host.executor.state)
    x4, y4 = images(4, seed + 21)
    t0 = time.perf_counter()
    lc = float(card.executor.train_batch([x4], y4)["loss"])
    torch.cuda.synchronize()
    card_step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lh = float(host.executor.train_batch([x4], y4)["loss"])
    cpu_step_s = time.perf_counter() - t0
    if not (np.isfinite(lc) and abs(lc - lh) <= 1e-4 * abs(lh)):
        raise AssertionError(f"vision: card loss {lc} vs CPU {lh} beyond rtol 1e-4")
    # the same step in float64 on the CPU (SGD's first step: -lr * grad),
    # the yardstick of how close two float32 runs of this step can be
    t0 = time.perf_counter()
    upd64 = sgd_first_step_f64(card.graph, before_p, snap_s4, x4, y4, lr=0.01)
    f64_s = time.perf_counter() - t0
    hp, cp = host.executor.params, card.executor.params

    def off(tree, k, n):  # a step's update against the float64 one
        return float(((tree[k][n].detach().cpu().double() - before_p[k][n].double())
                      - upd64[k][n]).abs().max())

    moved = max(float((hp[k][n].detach() - before_p[k][n]).abs().max()) for k in hp for n in hp[k])
    perr = max(float((cp[k][n].detach().cpu() - hp[k][n].detach()).abs().max())
               for k in hp for n in hp[k])
    cpu_off = max(off(hp, k, n) for k in hp for n in hp[k])
    card_off = max(off(cp, k, n) for k in hp for n in hp[k])
    # PARAM gate: 1e-3 of the largest change, or, where float32 itself is
    # farther from float64 than that (this step is: ~2% on the CPU too),
    # twice the CPU port's own distance from the float64 step
    param_lim = max(1e-3 * moved, 2 * cpu_off)
    if not 0 < moved or perr > param_lim or card_off > param_lim:
        raise AssertionError(f"vision: card params differ from the CPU's by {perr} and from the "
                             f"float64 step by {card_off}, beyond {param_lim} (the CPU's own "
                             f"distance from float64 {cpu_off}, the largest change {moved})")
    hs, cs_ = host.executor.state, card.executor.state
    serr = 0.0
    for k in hs:
        for n in hs[k]:
            e = float((cs_[k][n].cpu() - hs[k][n]).abs().max())
            if e > 1e-3 * float(hs[k][n].abs().max()):
                raise AssertionError(f"vision: running stat {k}.{n} differs by {e}")
            serr = max(serr, e)
    # eval mode reads the running statistics: the card's weights and stats on both
    for tree in ("params", "state"):
        load_tree(getattr(host.executor, tree), getattr(card.executor, tree))
    pe = check_close("vision eval (card vs CPU)", card.predict(x4).cpu(), host.predict(x4))
    n_bn = sum(1 for n in card.graph.nodes.values() if n.op_type == OpType.BATCHNORM)
    del host, before_p
    card_vs_cpu = {"loss_card": lc, "loss_cpu": lh, "param_max_abs_diff": perr,
                   "param_max_update": moved, "card_update_off_f64": card_off,
                   "cpu_update_off_f64": cpu_off, "param_gate": param_lim, "f64_step_s": f64_s,
                   "running_stat_max_abs_diff": serr,
                   "eval_max_abs_diff": pe, "card_step_s": card_step_s, "cpu_step_s": cpu_step_s,
                   "batchnorms": n_bn}

    # --- timed steps at batch 32
    batch, warm, steps = 32, 2, 10
    model = compiled(build_resnet50(FFConfig(batch_size=batch, seed=seed), classes, hw))
    ex = model.executor
    snap_p, snap_s = params_copy(ex.params), params_copy(ex.state)
    n_params = sum(p.numel() for g in ex.params.values() for p in g.values())
    xb, yb = images(batch, seed + 22)
    x, y = torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda()
    model.fit(x.repeat(warm, 1, 1, 1), y.repeat(warm), verbose=False)
    load_tree(ex.params, snap_p)
    load_tree(ex.state, snap_s)
    ex.opt_state = ex.optimizer.init_state(ex.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # eager steps, as the training phase
    model.fit(x.repeat(steps, 1, 1, 1), y.repeat(steps), verbose=False, trace_window=1)
    peak = torch.cuda.max_memory_allocated()
    losses, elapsed = model.step_losses, model.last_elapsed
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"vision: losses not finite or not falling: {losses}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        model.fit(x.repeat(2, 1, 1, 1), y.repeat(2), verbose=False)
        prof_wall = time.perf_counter() - tp
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    groups = {"convolution": 0.0, "BatchNorm and elementwise": 0.0, "GEMM": 0.0, "other": 0.0}
    for name, us in by_name.items():
        groups[vision_kernel_group(name)] += us / 1e3 / 2
    step_device_ms = sum(by_name.values()) / 1e3 / 2
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # the forward op by op (FFModel.profile), after the timed steps
    forward_profile = resnet_forward_profile(model, x)

    # --- remat: the same step with stage 3's blocks rematerialized
    rm = compiled(FFModel.from_graph(model.graph, FFConfig(batch_size=batch, seed=seed,
                                                            remat_blocks=True)))
    _, blocks, _ = rm.executor._remat_plan
    block_names = [[n.name for n in b.nodes] for b in blocks]
    if len(blocks) != 5 or not all(any(n.op_type == OpType.BATCHNORM for n in b.nodes)
                                   for b in blocks):
        raise AssertionError(f"vision remat: blocks {block_names}")
    step = {}
    for name, m in (("plain", model), ("remat", rm), ("remat", rm), ("plain", model)):
        e = m.executor
        load_tree(e.params, snap_p)
        load_tree(e.state, snap_s)
        e.opt_state = e.optimizer.init_state(e.params)
        loss, ms, pk, base = measured_step(e, [x], y, None)
        step.setdefault(name, {"runs": []})["runs"].append(
            {"loss": loss, "ms": ms, "peak_bytes": pk, "peak_over_before_bytes": pk - base})
        if "params" not in step[name]:
            step[name].update(params=params_copy(e.params), state=params_copy(e.state), loss=loss)
    a, b = step["plain"], step["remat"]
    if abs(a["loss"] - b["loss"]) > 1e-4 * abs(a["loss"]):
        raise AssertionError(f"vision remat: loss {b['loss']} vs {a['loss']}")
    rmoved = max(float((a["params"][k][n] - snap_p[k][n]).abs().max()) for k in snap_p
                 for n in snap_p[k])
    rerr = max(float((a["params"][k][n] - b["params"][k][n]).abs().max()) for k in snap_p
               for n in snap_p[k])
    if rerr > param_lim / moved * rmoved:
        raise AssertionError(f"vision remat: params differ by {rerr}, beyond the card-against-"
                             f"CPU gate's share {param_lim / moved} of the update {rmoved}")
    rserr = 0.0
    for k in snap_s:
        for n in snap_s[k]:
            e = float((a["state"][k][n] - b["state"][k][n]).abs().max())
            if e > 1e-3 * float(a["state"][k][n].abs().max()):
                raise AssertionError(f"vision remat: running stat {k}.{n} differs by {e}: "
                                     "applied other than once")
            rserr = max(rserr, e)
    bitwise = all(torch.equal(a["params"][k][n], b["params"][k][n]) for k in snap_p
                  for n in snap_p[k])
    if max(r["peak_bytes"] for r in b["runs"]) >= min(r["peak_bytes"] for r in a["runs"]):
        raise AssertionError(f"vision remat: peak memory not lower ({b['runs']} vs {a['runs']})")
    remat = {"blocks": len(blocks), "block_nodes": block_names[0],
             "runs": {k: step[k]["runs"] for k in step}, "param_max_abs_diff": rerr,
             "param_max_update": rmoved, "running_stat_max_abs_diff": rserr,
             "bitwise_equal": bitwise}
    del rm, step, a, b, model, ex
    torch.cuda.empty_cache()

    # --- the other builders: one forward each at batch 8, published sizes
    fwd = {}
    for name, build, size in (("alexnet", build_alexnet, 224), ("resnext50_32x4d", build_resnext50, 224),
                              ("inception_v3", build_inception_v3, 299)):
        m = build(FFConfig(batch_size=8, seed=seed), classes, size)
        m.compile(comp_mode=CompMode.INFERENCE)
        xi = torch.randn((8, 3, size, size), generator=torch.Generator(device="cuda")
                         .manual_seed(seed), device="cuda")
        probs = m.predict(xi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = m.predict(xi)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if (tuple(probs.shape) != (8, classes) or not torch.isfinite(probs).all()
                or float((probs.sum(-1) - 1).abs().max()) > 1e-4):
            raise AssertionError(f"vision {name}: output {tuple(probs.shape)} not 8 rows of "
                                 "probabilities")
        fwd[name] = {"image_hw": size, "forward_ms": ms,
                     "params": sum(p.numel() for g in m.executor.params.values()
                                   for p in g.values())}
        del m, probs
        torch.cuda.empty_cache()
    out = {"model": "resnet50", "image_hw": hw, "classes": classes, "batch": batch,
           "params": n_params, "card_vs_cpu": card_vs_cpu, "warmup_steps": warm,
           "timed_steps": steps, "elapsed_s": elapsed, "step_ms": 1e3 * elapsed / steps,
           "images_per_s": steps * batch / elapsed, "loss_first": losses[0],
           "loss_last": losses[-1], "peak_mem_gb": peak / 1e9,
           "profiled_wall_s": prof_wall, "step_device_ms": step_device_ms,
           "device_busy_share_of_timed_step": step_device_ms / (1e3 * elapsed / steps),
           "step_device_ms_by_group": groups,
           "top_device_us": {n[:100]: us / 2 for n, us in top},
           "remat": remat, "forward_other": fwd, "forward_profile": forward_profile,
           "phase_s": time.perf_counter() - t_phase}
    print("vision (ResNet-50, 224 x 224, batch 32, fp32): " + json.dumps(out))
    return out


WINDOW_STEPS, WINDOW_TW = 16, 8  # the window phase: 16 steps, two windows of 8


def take_launches(total: dict) -> dict:
    """The flash launches since the last reset, added into ``total``;
    the counts are reset."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    got = dict(fa.LAUNCHES)
    for k, n in got.items():
        total[k] = total.get(k, 0) + n
    fa.reset_launch_counts()
    return got


def trees_equal(a, b) -> bool:
    import torch

    return all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])


def max_tree_diff(a, b) -> float:
    return max((float((a[k][n].detach().float() - b[k][n].detach().float()).abs().max())
                for k in a for n in a[k]), default=0.0)


def window_cell(tag: str, model, xs, y, batch: int, per_step=None, steps: int = WINDOW_STEPS,
                tw: int = WINDOW_TW) -> dict:
    """``steps`` train steps of ``model`` (SGD without momentum: its
    parameters are its whole training state) two ways from the same
    weights and keys: ``fit(trace_window=tw)`` (the window path: a warm-up
    step, the capture, then replays) against ``train_batch`` calls. Gate:
    every loss and the final parameters bit for bit (else the largest
    difference, held to ``step_gates``), one capture, ``per_step`` flash
    launches a step on both paths. Then host ms a step in turns (window,
    eager, eager, window), a profiled run of 8 steps of each (device ms a
    step, busy share) and the peak memory of each path."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    ex = model.executor
    snap = params_copy(ex.params)
    words = model._step_words(1, steps, tw)
    total = {}

    def eager(n):
        mets = [ex.train_batch([t[i * batch:(i + 1) * batch] for t in xs],
                               y[i * batch:(i + 1) * batch], rng=(words[i, 0], words[i, 1]))
                for i in range(n)]
        return [float(m["loss"]) for m in mets]  # one host sync, after the last step

    def window(n):
        model.fit([t[:n * batch] for t in xs], y[:n * batch], batch_size=batch, verbose=False,
                  trace_window=min(tw, n))
        return list(model.step_losses)

    def timed(fn, n):
        load_tree(ex.params, snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        losses = fn(n)
        torch.cuda.synchronize()
        return losses, 1e3 * (time.perf_counter() - t0) / n, torch.cuda.max_memory_allocated() - base

    fa.reset_launch_counts()  # an earlier phase's counts are its own
    le, e_ms, e_peak = timed(eager, steps)
    pe, launch_e = params_copy(ex.params), take_launches(total)
    captures0 = ex.graph_captures
    lw, w_first_ms, w_peak = timed(window, steps)
    pw, launch_w = params_copy(ex.params), take_launches(total)
    captures = ex.graph_captures - captures0
    bitwise = le == lw and trees_equal(pe, pw)
    gate = {"bitwise_equal": bitwise, "loss_max_abs_diff": max(abs(a - b) for a, b in zip(le, lw)),
            "param_max_abs_diff": max_tree_diff(pe, pw)}
    if not bitwise:
        print(f"{tag}: window vs eager not bit for bit: losses {lw} vs {le}, parameters differ "
              f"by up to {gate['param_max_abs_diff']}")
        dtype = next(iter(next(iter(snap.values())).values())).dtype
        gate.update(step_gates(f"{tag} window vs eager", dtype, snap, pe, pw, le[-1], lw[-1]))
    if captures != 1:
        raise AssertionError(f"{tag}: {captures} captures for one geometry")
    if per_step is not None:
        want = {k: n * steps for k, n in per_step.items()}
        for name, got in (("eager", launch_e), ("window", launch_w)):
            if {k: n for k, n in got.items() if n} != {k: n for k, n in want.items() if n}:
                raise AssertionError(f"{tag} {name}: flash launches {got}, expected {want}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), le)):
        raise AssertionError(f"{tag}: losses not finite: {le}")
    del pe, pw
    runs = {"window": [], "eager": []}
    for mode in ("window", "eager", "eager", "window"):
        runs[mode].append(timed(window if mode == "window" else eager, steps)[1])
    take_launches(total)
    prof = {}
    for mode in ("eager", "window"):
        load_tree(ex.params, snap)
        fn = window if mode == "window" else eager
        wall, busy = busy_share(lambda: fn(8))
        prof[mode] = {"wall_s": wall, "device_busy_s": busy, "device_ms_per_step": 1e3 * busy / 8,
                      "busy_share": busy / wall}
    take_launches(total)
    load_tree(ex.params, snap)
    graphs = list(ex._graphs.values())
    out = {"gate": gate, "steps": steps, "trace_window": tw, "batch": batch,
           "host_ms_per_step": runs, "first_window_run_ms_per_step": w_first_ms,
           "first_eager_run_ms_per_step": e_ms,
           "device_ms_per_step": {m: p["device_ms_per_step"] for m, p in prof.items()},
           "busy_share_profiled": {m: p["busy_share"] for m, p in prof.items()},
           "busy_share_of_timed_step": {m: prof[m]["device_ms_per_step"] / min(runs[m])
                                        for m in prof},
           "profiled": prof, "captures": captures,
           "capture_s": [g.capture_s for g in graphs if g.capture_s is not None],
           "peak_bytes_over_run": {"eager": e_peak, "window": w_peak},
           "launches": total, "losses": le}
    print(f"window {tag}: " + json.dumps(out))
    return out


def window_bert(seed: int, dtype) -> dict:
    """BERT-Base (the trainer phase's model) in ``dtype``: the window cell;
    for bf16 also ``train_batch_repeated`` and the eval window against
    eager steps, and Adam with ``set_learning_rate`` between two windows."""
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType, MetricsType
    from flexflow_tpu_torch.generation import prng
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.runtime import AdamOptimizer, SGDOptimizer

    t_phase = time.perf_counter()
    cfg = bert_base(dtype)
    batch, layers = 32, cfg.num_layers
    form = FLASH_FORMS[str(cfg.dtype.torch)[6:]]
    tag = "bert-base " + {"": "fp32", "_bf16": "bf16", "_f16": "fp16"}[form]

    def compiled(opt):
        m = build_transformer(FFConfig(batch_size=batch, seed=seed), cfg)
        return m.compile(optimizer=opt, loss_type=LossType.MEAN_SQUARED_ERROR,
                         metrics=[MetricsType.MEAN_SQUARED_ERROR])

    model = compiled(SGDOptimizer(lr=0.01))
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    shape = (WINDOW_STEPS * batch, cfg.seq_length, cfg.hidden_size)
    x = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    y = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    per_step = {f"{k}{form}": layers for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out = window_cell(tag, model, [x], y, batch, per_step)
    if dtype != DataType.BFLOAT16:
        out["phase_s"] = time.perf_counter() - t_phase
        del model, x, y
        torch.cuda.empty_cache()
        return out

    ex, total = model.executor, out["launches"]
    snap = params_copy(ex.params)
    rng = tuple(t.cuda() for t in prng.key(seed + 33))
    xb, yb = x[:batch], y[:batch]
    # train_batch_repeated: 8 steps on one batch, keys fold_in(rng, i)
    captures0 = ex.graph_captures
    words = ex._split_words(rng, 8)
    eager = [float(ex.train_batch([xb], yb, rng=(w[0], w[1]))["loss"]) for w in words][-1]
    pe = params_copy(ex.params)
    load_tree(ex.params, snap)
    last = float(ex.train_batch_repeated([xb], yb, rng, 8)["loss"])
    repeated = {"loss_eager": eager, "loss_window": last, "bitwise_equal":
                last == eager and trees_equal(pe, ex.params),
                "param_max_abs_diff": max_tree_diff(pe, ex.params)}
    if not repeated["bitwise_equal"]:
        repeated.update(step_gates(f"{tag} train_batch_repeated vs eager", cfg.dtype.torch, snap,
                                   pe, params_copy(ex.params), eager, last))
    # the eval window and evaluate(trace_window=8) against eval steps
    xs, ys = x.reshape(WINDOW_STEPS, batch, *shape[1:]), y.reshape(WINDOW_STEPS, batch, *shape[1:])
    ev_window = ex.eval_window([xs[:8]], ys[:8])["loss"].tolist()
    ev_eager = [float(ex.eval_batch([xs[i]], ys[i])["loss"]) for i in range(8)]
    perf_w = model.evaluate(x, y, trace_window=8)
    perf_e = model.evaluate(x, y, trace_window=1)
    evaluate = {"losses_window": ev_window, "losses_eager": ev_eager,
                "bitwise_equal": ev_window == ev_eager and perf_w.mse_loss == perf_e.mse_loss,
                "mse_loss_window": perf_w.mse_loss, "mse_loss_eager": perf_e.mse_loss}
    if not evaluate["bitwise_equal"] and not all(
            abs(a - b) <= HALF_LOSS_RTOL["bfloat16"] * abs(b) for a, b in zip(ev_window, ev_eager)):
        raise AssertionError(f"{tag}: eval window losses {ev_window} vs eval steps {ev_eager}")
    if ex.graph_captures - captures0 != 1:  # the eval step's; the train step's exists
        raise AssertionError(f"{tag}: {ex.graph_captures - captures0} captures for the repeated "
                             "train steps and the eval window, expected the eval step's alone")
    take_launches(total)
    del model, ex, snap, pe
    torch.cuda.empty_cache()

    # Adam with the learning rate changed between two windows of 8
    model = compiled(AdamOptimizer(alpha=1e-4))
    ex = model.executor
    snap = params_copy(ex.params)
    words = model._step_words(1, WINDOW_STEPS, WINDOW_TW)

    def reset():
        load_tree(ex.params, snap)
        for f in ("m", "v"):
            for g in ex.opt_state[f].values():
                for t in g.values():
                    t.zero_()
        ex.opt_state["step"] = 0
        ex.set_learning_rate(1e-4)

    reset()
    le = []
    for i in range(WINDOW_STEPS):
        if i == WINDOW_TW:
            ex.set_learning_rate(5e-5)
        le.append(ex.train_batch([xs[i]], ys[i], rng=(words[i, 0], words[i, 1])))
    le = [float(m["loss"]) for m in le]
    pe = params_copy(ex.params)
    reset()
    lw = ex._train_window([xs[:WINDOW_TW]], ys[:WINDOW_TW], words[:WINDOW_TW])["loss"]
    ex.set_learning_rate(5e-5)
    lw = lw.tolist() + ex._train_window([xs[WINDOW_TW:]], ys[WINDOW_TW:],
                                        words[WINDOW_TW:])["loss"].tolist()
    lr = {"captures": ex.graph_captures, "bitwise_equal": le == lw and trees_equal(pe, ex.params),
          "param_max_abs_diff": max_tree_diff(pe, ex.params), "losses_window": lw,
          "losses_eager": le}
    if ex.graph_captures != 1:
        raise AssertionError(f"{tag} Adam: {ex.graph_captures} captures across the rate change")
    if not lr["bitwise_equal"]:
        lr.update(step_gates(f"{tag} Adam set_learning_rate window vs eager", cfg.dtype.torch, snap,
                             pe, params_copy(ex.params), le[-1], lw[-1]))
    take_launches(total)
    out.update(repeated=repeated, evaluate=evaluate, set_learning_rate=lr,
               phase_s=time.perf_counter() - t_phase)
    print(f"window {tag} repeated / evaluate / set_learning_rate: " + json.dumps(
        {"repeated": repeated, "evaluate": evaluate, "set_learning_rate": lr}))
    del model, ex, snap, pe, x, y, xs, ys
    torch.cuda.empty_cache()
    return out


def card_vs_cpu_step(tag: str, card, xs, y) -> dict:
    """One SGD step of ``card`` (a compiled model on the card) and of the
    same graph on the CPU from the same weights and key: the training
    phase's fp32 gates (loss rtol 1e-5, parameters within PARAM_STEP_RTOL
    of the step's largest update)."""
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    host = FFModel.from_graph(card.graph, FFConfig(batch_size=card.config.batch_size),
                              device="cpu")
    host.compile(optimizer=type(card.optimizer)(lr=card.optimizer.lr),
                 loss_type=card.loss_type,
                 outputs=host.output_tensors([(t.node.guid, t.idx) for t in card._outputs]))
    load_tree(host.executor.params, card.executor.params)
    before = params_copy(host.executor.params)
    t0 = time.perf_counter()
    lc = float(card.executor.train_batch([t.cuda() for t in xs], y.cuda())["loss"])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lh = float(host.executor.train_batch(xs, y)["loss"])
    cpu_s = time.perf_counter() - t0
    cp = {k: {n: t.detach().cpu() for n, t in g.items()} for k, g in card.executor.params.items()}
    gates = step_gates(f"{tag} card vs CPU", torch.float32, before, host.executor.params, cp, lh,
                       lc)
    gates.update(card_step_s=card_s, cpu_step_s=cpu_s)
    return gates


# the window phase's NMT and DLRM cells at build_nmt's and build_dlrm's default widths
# (flexflow_tpu_torch/models/nmt.py, recommender.py) and batches
NMT_WIDTHS = dict(src_vocab=32000, tgt_vocab=32000, embed_dim=256, hidden_size=256, num_layers=2,
                  src_len=32, tgt_len=32)
NMT_BATCH = 64
DLRM_WIDTHS = dict(embedding_sizes=(1000000,) * 8, embedding_dim=64, embedding_bag_size=1,
                   dense_dim=64, bottom_mlp=(512, 256, 64), top_mlp=(512, 256, 1))
DLRM_BATCH, DLRM_SMALL_ROWS = 256, 10000  # examples/dlrm.py's -b 256


def window_nmt(seed: int) -> dict:
    """NMT at ``build_nmt``'s default widths (``NMT_WIDTHS``: vocab 32000 both
    sides, embed 256, hidden 256, 2 LSTM layers, source and target 32,
    attention; fp32, SGD lr 0.01, sparse categorical cross-entropy): a
    batch-4 step card against CPU, then the window cell at batch 64."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.models import build_nmt
    from flexflow_tpu_torch.runtime import SGDOptimizer

    t_phase = time.perf_counter()
    w = NMT_WIDTHS

    def compiled(batch):
        m = build_nmt(FFConfig(batch_size=batch, seed=seed), **w)
        return m.compile(optimizer=SGDOptimizer(lr=0.01),
                         loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)

    def tokens(n, s):
        rs = np.random.RandomState(s)
        src = rs.randint(0, w["src_vocab"], (n, w["src_len"])).astype(np.int32)
        tgt = rs.randint(0, w["tgt_vocab"], (n, w["tgt_len"])).astype(np.int32)
        lab = rs.randint(0, w["tgt_vocab"], (n, w["tgt_len"])).astype(np.int32)
        return [torch.from_numpy(src), torch.from_numpy(tgt)], torch.from_numpy(lab)

    small = compiled(4)
    cpu = card_vs_cpu_step("nmt", small, *tokens(4, seed + 41))
    del small
    model = compiled(NMT_BATCH)
    xs, y = tokens(WINDOW_STEPS * NMT_BATCH, seed + 42)
    out = window_cell("nmt", model, [t.cuda() for t in xs], y.cuda(), NMT_BATCH, per_step={})
    out.update(card_vs_cpu=cpu, widths=dict(w), phase_s=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    return out


def window_dlrm(seed: int) -> dict:
    """DLRM at ``build_dlrm``'s default widths (``DLRM_WIDTHS``: 8 tables x
    1,000,000 rows x 64, bag 1, dense 64, bottom 512-256-64, top
    512-256-1; batch 256, fp32, SGD lr 0.01, MSE): a batch-4 step card
    against CPU on 10,000-row tables, then the window cell at full width."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.models import build_dlrm
    from flexflow_tpu_torch.runtime import SGDOptimizer

    t_phase = time.perf_counter()
    w = DLRM_WIDTHS
    tables = len(w["embedding_sizes"])

    def compiled(batch, rows):
        m = build_dlrm(FFConfig(batch_size=batch, seed=seed),
                       **{**w, "embedding_sizes": (rows,) * tables})
        return m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)

    def inputs(n, rows, s):
        rs = np.random.RandomState(s)
        xs = [torch.from_numpy(rs.randint(0, rows, (n, w["embedding_bag_size"])).astype(np.int32))
              for _ in range(tables)]
        xs.append(torch.from_numpy(rs.randn(n, w["dense_dim"]).astype(np.float32)))
        return xs, torch.from_numpy(rs.rand(n, 1).astype(np.float32))

    small = compiled(4, DLRM_SMALL_ROWS)
    cpu = card_vs_cpu_step("dlrm", small, *inputs(4, DLRM_SMALL_ROWS, seed + 51))
    del small
    rows = w["embedding_sizes"][0]
    t0 = time.perf_counter()
    model = compiled(DLRM_BATCH, rows)
    setup_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size() for g in model.executor.params.values()
                      for n, t in g.items() if n == "embedding")
    xs, y = inputs(WINDOW_STEPS * DLRM_BATCH, rows, seed + 52)
    out = window_cell("dlrm", model, [t.cuda() for t in xs], y.cuda(), DLRM_BATCH, per_step={})
    out.update(card_vs_cpu=cpu, table_bytes=table_bytes, setup_s=setup_s,
               widths={k: list(v) if isinstance(v, tuple) else v for k, v in w.items()},
               samples_per_s={m: [1e3 * DLRM_BATCH / ms for ms in r]
                              for m, r in out["host_ms_per_step"].items()},
               phase_s=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    return out


def window_phase(seed: int) -> dict:
    """The executor's window path against its eager steps: BERT-Base in
    fp32 and bf16 (with the repeated steps, the eval window and Adam's
    rate change in bf16), NMT and DLRM."""
    from flexflow_tpu_torch.core.types import DataType

    t0 = time.perf_counter()
    out = {"bert-base fp32": window_bert(seed, DataType.FLOAT),
           "bert-base bf16": window_bert(seed, DataType.BFLOAT16),
           "nmt": window_nmt(seed), "dlrm": window_dlrm(seed)}
    out["phase_s"] = time.perf_counter() - t0
    return out


def print_window(card: str, window: dict) -> None:
    """The window phase's lines of the summary."""
    for cell in ("bert-base fp32", "bert-base bf16", "nmt", "dlrm"):
        w = window[cell]
        print(f"{card}: window phase, {cell} (batch {w['batch']}, {w['steps']} steps, windows of "
              f"{w['trace_window']}): host ms a step eager "
              + ", ".join(f"{ms:.3f}" for ms in w["host_ms_per_step"]["eager"]) + " / window "
              + ", ".join(f"{ms:.3f}" for ms in w["host_ms_per_step"]["window"])
              + f"; device ms a step eager {w['device_ms_per_step']['eager']:.3f} / window "
              f"{w['device_ms_per_step']['window']:.3f}; busy share of the timed step eager "
              f"{w['busy_share_of_timed_step']['eager']:.3f} / window "
              f"{w['busy_share_of_timed_step']['window']:.3f} (profiled "
              f"{w['busy_share_profiled']['eager']:.3f} / {w['busy_share_profiled']['window']:.3f})"
              f"; capture s " + ", ".join(f"{c:.3f}" for c in w["capture_s"])
              + f"; peak GB over a run eager {w['peak_bytes_over_run']['eager'] / 1e9:.3f} / "
              f"window {w['peak_bytes_over_run']['window'] / 1e9:.3f}; bit for bit "
              f"{w['gate']['bitwise_equal']}"
              + (f"; samples/s eager " + ", ".join(f"{v:.1f}" for v in w["samples_per_s"]["eager"])
                 + " / window " + ", ".join(f"{v:.1f}" for v in w["samples_per_s"]["window"])
                 if "samples_per_s" in w else ""))
    wb = window["bert-base bf16"]
    print(f"{card}: window phase, bert-base bf16: train_batch_repeated(8) bit for bit "
          f"{wb['repeated']['bitwise_equal']}, eval window bit for bit "
          f"{wb['evaluate']['bitwise_equal']}, Adam set_learning_rate between windows bit for "
          f"bit {wb['set_learning_rate']['bitwise_equal']} with "
          f"{wb['set_learning_rate']['captures']} capture; NMT card vs CPU loss "
          f"{window['nmt']['card_vs_cpu']['loss_b']:.6f} vs "
          f"{window['nmt']['card_vs_cpu']['loss_a']:.6f}, DLRM "
          f"{window['dlrm']['card_vs_cpu']['loss_b']:.6f} vs "
          f"{window['dlrm']['card_vs_cpu']['loss_a']:.6f}; phase {window['phase_s']:.1f} s")


# examples/moe.py's shape (build_moe_mlp's defaults) and its -b 64
MOE_SHAPE = dict(in_dim=784, num_classes=10, num_experts=8, num_select=2, expert_hidden=64,
                 alpha=2.0, lambda_bal=0.04)
MOE_BATCH, MOE_LR = 64, 0.01


def moe_compiled(config, **kw):
    """``build_moe_mlp`` at ``MOE_SHAPE`` on the card, compiled as
    examples/moe.py (SGD, sparse categorical cross-entropy, accuracy)."""
    from flexflow_tpu_torch.core.types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_moe_mlp
    from flexflow_tpu_torch.runtime import SGDOptimizer

    m = build_moe_mlp(config, **{**MOE_SHAPE, **kw})
    return m.compile(optimizer=SGDOptimizer(lr=MOE_LR),
                     loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                     metrics=[MetricsType.ACCURACY])


def moe_data(n: int, seed: int):
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(n, MOE_SHAPE["in_dim"]).astype(np.float32)),
            torch.from_numpy(rs.randint(0, MOE_SHAPE["num_classes"], (n,)).astype(np.int32)))


def moe_routing(model, x) -> tuple:
    """(top-k values, top-k indices, gate probabilities) of one batch from
    ``model``'s weights: its executor's inference forward with the outputs
    swapped for the top-k node's and the gate's."""
    ex = model.executor
    order = model.graph.topo_order()
    topk = next(n for n in order if n.op_type.value == "topk")
    gate = next(n for n in order if n.name == "moe_gate_sm")
    saved = ex.outputs
    ex.outputs = [(topk.guid, 0), (topk.guid, 1), (gate.guid, 0)]
    try:
        return tuple(ex.predict([x]))
    finally:
        ex.outputs = saved


def moe_per_expert(config):
    """The MoE MLP with ``batched=False``: the reference's n Dense pairs
    (the per-expert model of tests/test_moe_ep.py, at MOE_SHAPE)."""
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import SGDOptimizer

    s = MOE_SHAPE
    m = FFModel(config)
    x = m.create_tensor((config.batch_size, s["in_dim"]), name="input")
    t = m.moe(x, s["num_experts"], s["num_select"], s["expert_hidden"], s["alpha"],
              s["lambda_bal"], batched=False, name="moe")
    m.softmax(m.dense(t, s["num_classes"], name="head"), name="softmax")
    return m.compile(optimizer=SGDOptimizer(lr=MOE_LR),
                     loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)


def moe_aggregate_spec(seed: int) -> dict:
    """AggregateSpec alone at the phase's shape (B 64, k 2, 8 experts of
    capacity 32, D 784; token 0 picks one expert twice): forward and the
    gate and expert gradients on the card against the CPU. The rows and
    the expert gradient are gathers (bit for bit); the gate gradient sums
    squares over D in another order (rtol 1e-5, atol 1e-6)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops import moe_ops
    from flexflow_tpu_torch.ops.base import LowerCtx

    b, k, n, d = MOE_BATCH, MOE_SHAPE["num_select"], MOE_SHAPE["num_experts"], MOE_SHAPE["in_dim"]
    cap = moe_ops.expert_capacity(b, k, n, MOE_SHAPE["alpha"])
    rs = np.random.RandomState(seed + 63)
    gate = torch.from_numpy(rs.rand(b, k).astype(np.float32))
    assign = torch.from_numpy(rs.randint(0, n, (b, k)).astype(np.int32))
    assign[0, 1] = assign[0, 0]
    stacked = torch.from_numpy(rs.randn(n, cap, d).astype(np.float32))
    ct = torch.from_numpy(rs.randn(b * k, d).astype(np.float32))
    res = {}
    for dev, put in (("cuda", lambda t: t.cuda()), ("cpu", lambda t: t)):
        g, e = put(gate).requires_grad_(True), put(stacked).requires_grad_(True)
        (out,) = moe_ops.AggregateSpecOp.lower(
            moe_ops.AggregateSpecParams(n, MOE_SHAPE["lambda_bal"]), [g, put(assign), e], {},
            LowerCtx())
        (out * put(ct)).sum().backward()
        res[dev] = [t.detach().cpu() for t in (out, g.grad, e.grad)]
    (oc, gc, ec), (oh, gh, eh) = res["cuda"], res["cpu"]
    if not (torch.equal(oc, oh) and torch.equal(ec, eh)):
        raise AssertionError("moe aggregate_spec: rows or expert gradient differ card vs CPU")
    if not torch.allclose(gc, gh, rtol=1e-5, atol=1e-6) or not bool((gh != 0).any()):
        raise AssertionError(f"moe aggregate_spec: gate gradient differs by "
                             f"{float((gc - gh).abs().max())}")
    return {"shape": {"batch": b, "k": k, "experts": n, "capacity": cap, "d": d},
            "gate_grad_max_abs_diff": float((gc - gh).abs().max()),
            "rows_and_expert_grad_bitwise": True}


def moe_elastic(seed: int, xs, y) -> dict:
    """``ElasticTrainer`` over the MoE MLP on the card, 8 steps with
    checkpoints every 4: clean, then from the same weights with an error
    injected at ``elastic.step`` on step 6 (restored from step 4, steps
    4-7 replayed): the final parameters and loss bit for bit."""
    import shutil
    import tempfile

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.runtime.elastic import ElasticTrainer

    m = moe_compiled(FFConfig(batch_size=MOE_BATCH, seed=seed))
    ex = m.executor
    snap = params_copy(ex.params)

    def batches(step):
        lo = step * MOE_BATCH
        return [xs[lo:lo + MOE_BATCH]], y[lo:lo + MOE_BATCH]

    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        t0 = time.perf_counter()
        clean = ElasticTrainer(m, os.path.join(root, "clean"), checkpoint_every=4,
                               sleep=lambda s: None).run(batches, 8)
        clean_s = time.perf_counter() - t0
        p_clean = params_copy(ex.params)
        load_tree(ex.params, snap)
        ex.opt_state = ex.optimizer.init_state(ex.params)
        plan = faults.FaultPlan().on("elastic.step", mode="error",
                                     error=RuntimeError("injected device loss"),
                                     when=lambda step: step == 6, max_fires=1)
        t0 = time.perf_counter()
        with plan.active():
            fault = ElasticTrainer(m, os.path.join(root, "fault"), checkpoint_every=4,
                                   sleep=lambda s: None).run(batches, 8)
        fault_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if fault.restarts != 1 or fault.steps_completed != 8 or clean.restarts != 0:
        raise AssertionError(f"moe elastic: reports {clean} / {fault}")
    bitwise = fault.final_loss == clean.final_loss and trees_equal(p_clean, ex.params)
    if not bitwise:
        raise AssertionError(f"moe elastic: the recovered run differs from the clean one (loss "
                             f"{fault.final_loss} vs {clean.final_loss}, parameters by "
                             f"{max_tree_diff(p_clean, ex.params)})")
    return {"steps": 8, "checkpoint_every": 4, "fault_at_step": 6, "restarts": fault.restarts,
            "checkpoints_saved": [clean.checkpoints_saved, fault.checkpoints_saved],
            "final_loss": fault.final_loss, "bitwise_equal": bitwise, "clean_s": clean_s,
            "fault_s": fault_s}


def moe_phase(seed: int) -> dict:
    """The mixture-of-experts MLP at examples/moe.py's shape (MOE_SHAPE,
    batch 64, fp32, SGD lr 0.01, sparse categorical cross-entropy):
    card against CPU, the window path against eager steps, batched
    against per-expert, the recompile, AggregateSpec alone, elastic
    recovery and the profiling flag."""
    import io

    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.ops import moe_ops
    from flexflow_tpu_torch.runtime.executor import node_key

    t_phase = time.perf_counter()
    n, k = MOE_SHAPE["num_experts"], MOE_SHAPE["num_select"]
    cap = moe_ops.expert_capacity(MOE_BATCH, k, n, MOE_SHAPE["alpha"])
    xs, y = moe_data(WINDOW_STEPS * MOE_BATCH, seed + 61)

    # --- the card against the CPU: routing, then one step (training gates)
    card = moe_compiled(FFConfig(batch_size=MOE_BATCH, seed=seed))
    host = FFModel.from_graph(card.graph, FFConfig(batch_size=MOE_BATCH, seed=seed), device="cpu")
    host.compile(optimizer=type(card.optimizer)(lr=MOE_LR), loss_type=card.loss_type,
                 outputs=host.output_tensors([(t.node.guid, t.idx) for t in card._outputs]))
    load_tree(host.executor.params, card.executor.params)
    x0, y0 = xs[:MOE_BATCH], y[:MOE_BATCH]
    vc, ic, _ = moe_routing(card, x0.cuda())
    vh, ih, gate = moe_routing(host, x0)
    if not torch.equal(ic.cpu(), ih):
        raise AssertionError(f"moe: routing differs card vs CPU at "
                             f"{int((ic.cpu() != ih).sum())} of {ih.numel()} slots")
    _, pos = moe_ops._dispatch_positions(ih, n)
    top = gate.sort(dim=-1, descending=True).values
    margin = float((top[:, k - 1] - top[:, k]).min())
    routing = {"slots": ih.numel(), "dropped": int((pos >= cap).sum()), "capacity": cap,
               "topk_values_max_abs_diff": float((vc.cpu() - vh).abs().max()),
               "smallest_topk_margin": margin,
               "tokens_per_expert": torch.bincount(ih.reshape(-1).long(), minlength=n).tolist()}
    print(f"moe routing card vs CPU: equal; " + json.dumps(routing))
    del host
    step = card_vs_cpu_step("moe", card, [x0], y0)

    # --- the window path against eager steps (bit for bit, one capture)
    window = window_cell("moe", card, [xs.cuda()], y.cuda(), MOE_BATCH, per_step={})
    if not window["gate"]["bitwise_equal"]:
        raise AssertionError("moe: the window fit is not bit for bit with the eager steps")

    # --- batched against per-expert, from the same weights
    per = moe_per_expert(FFConfig(batch_size=MOE_BATCH, seed=seed))
    for layer in ("moe_gate", "head"):
        for w in ("kernel", "bias"):
            per.set_weight(layer, w, card.get_weight(layer, w))
    for e in range(n):
        for src, dst in (("w1", ("", "kernel")), ("b1", ("", "bias")),
                         ("w2", ("_out", "kernel")), ("b2", ("_out", "bias"))):
            per.set_weight(f"moe_exp{e}{dst[0]}", dst[1], card.get_weight("moe_experts", src)[e])
    xb = xs[MOE_BATCH:2 * MOE_BATCH].cuda()
    ob, op = card.predict(xb), per.predict(xb)
    if not torch.allclose(op, ob, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"moe: per-expert output differs from batched by "
                             f"{float((op - ob).abs().max())}")
    batched = {"max_abs_diff": float((op - ob).abs().max()), "rtol": 1e-5, "atol": 1e-6}
    del per

    # --- recompile: the cache op, the trigger on cache_score, weights kept
    rc = moe_compiled(FFConfig(batch_size=MOE_BATCH, seed=seed), use_cache=True)
    xw, yw = xs[:8 * MOE_BATCH].cuda(), y[:8 * MOE_BATCH].cuda()
    rc.fit(xw, yw, batch_size=MOE_BATCH, verbose=False, trace_window=8)
    old = rc.executor
    captures_before = old.graph_captures
    named = {nd.name: list(old.params[node_key(nd)]) for nd in rc.graph.nodes.values()
             if node_key(nd) in old.params}
    before = {layer: {w: rc.get_weight(layer, w) for w in ws} for layer, ws in named.items()}
    calls = []
    st = rc.recompile_on_condition(lambda s: s.cache_score > 0.5, lambda s: calls.append(1))
    st.cache_score = 0.1
    quiet = st.trigger_and_alter()
    st.cache_score = 0.9
    t0 = time.perf_counter()
    fired = st.trigger_and_alter()
    recompile_s = time.perf_counter() - t0
    if quiet or not fired or calls != [1] or st.recompilations != 1 or rc.executor is old:
        raise AssertionError(f"moe recompile: fired {quiet}, {fired}, {st.recompilations}")
    if old._graphs:
        raise AssertionError("moe recompile: the old executor keeps its captured graphs")
    for layer, ws in before.items():
        for w, a in ws.items():
            if not np.array_equal(rc.get_weight(layer, w), a):
                raise AssertionError(f"moe recompile: {layer}.{w} changed")
    rc.fit(xw, yw, batch_size=MOE_BATCH, verbose=False, trace_window=8)
    after = list(rc.step_losses)
    if rc.executor.graph_captures != 1 or not all(np.isfinite(after)) or not after[-1] < after[0]:
        raise AssertionError(f"moe recompile: {rc.executor.graph_captures} captures after it, "
                             f"losses {after}")
    recompile = {"captures_before": captures_before, "captures_after": rc.executor.graph_captures,
                 "recompilations": st.recompilations, "weights_kept_bitwise": True,
                 "layers": len(before), "recompile_s": recompile_s,
                 "losses_after": [after[0], after[-1]]}
    del rc, old

    spec = moe_aggregate_spec(seed)
    elastic = moe_elastic(seed, xs.cuda(), y.cuda())

    # --- FFConfig(profiling=True): fit prints the per-op table once
    pm = moe_compiled(FFConfig(batch_size=MOE_BATCH, seed=seed, profiling=True))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pm.fit(xs[:2 * MOE_BATCH].cuda(), y[:2 * MOE_BATCH].cuda(), batch_size=MOE_BATCH,
               verbose=False)
    table = buf.getvalue()
    if table.count("TFLOP/s") != 1 or "experts" not in table:
        raise AssertionError(f"moe profiling: fit printed {table!r}")
    print("moe per-op forward (FFConfig(profiling=True), CUDA events):\n" + table.rstrip())
    del pm, card
    torch.cuda.empty_cache()
    out = {"shape": dict(MOE_SHAPE), "batch": MOE_BATCH, "routing": routing,
           "card_vs_cpu": step, "window": window, "batched_vs_per_expert": batched,
           "recompile": recompile, "aggregate_spec": spec, "elastic": elastic,
           "profile_table": table, "phase_s": time.perf_counter() - t_phase}
    print("moe: " + json.dumps({k_: v for k_, v in out.items() if k_ != "profile_table"}))
    return out


def keras_phase(seed: int) -> dict:
    """The Keras frontend on the card. examples/keras_mnist.py's
    Sequential model (Dense 128 ReLU over 784, Dropout 0.2, Dense 10
    softmax; SGD 0.05, batch 64, 512 samples, one epoch) against the
    same graph on the CPU from the same weights and key chain: the
    dropout masks bit for bit, the first step's loss within rtol 1e-5,
    every loss within rtol 1e-4 and each parameter within 1e-3 of its
    largest change over the epoch. Then the functional CNN of
    tests/test_keras_frontend.py (two 3x3 convolutions concatenated,
    max pool, Dense 10 softmax over 3 x 16 x 16; Adam 0.001, batch 16,
    64 samples, one epoch): eval card against CPU before training (atol
    1e-4 + rtol 1e-4), the first step's loss within rtol 1e-5, then ``predict``:
    probabilities, finite; the distance to the CPU's after the epoch is
    reported (Adam's first steps move each weight by about lr times the
    sign of its gradient, so a gradient near zero may move the two runs
    apart by 2 lr)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.frontends import keras
    from flexflow_tpu_torch.model import FFModel

    t_phase = time.perf_counter()

    def cpu_twin(card_ff, optimizer):
        host = FFModel.from_graph(card_ff.graph, card_ff.config, seed=card_ff._seed, device="cpu")
        host.compile(optimizer=optimizer, loss_type=card_ff.loss_type, metrics=card_ff.metrics,
                     outputs=host.output_tensors([(t.node.guid, t.idx) for t in card_ff._outputs]))
        load_tree(host.executor.params, card_ff.executor.params)
        return host

    # --- examples/keras_mnist.py
    bs = 64
    seq = keras.Sequential([keras.Dense(128, activation="relu", input_shape=(784,)),
                            keras.Dropout(0.2), keras.Dense(10, activation="softmax")])
    seq.compile(optimizer=keras.SGD(learning_rate=0.05), loss="sparse_categorical_crossentropy",
                metrics=["accuracy"], config=FFConfig(batch_size=bs, seed=seed,
                                                      printing_interval=1000))
    seq._ensure_built(bs)
    card = seq.ffmodel
    host = cpu_twin(card, seq.optimizer.to_ff())
    before = params_copy(host.executor.params)
    rs = np.random.RandomState(seed + 71)
    x = rs.rand(512, 784).astype(np.float32)
    y = rs.randint(0, 10, 512).astype(np.int32)
    masks = {"card": [], "cpu": []}
    with recorded_masks(masks["card"]):
        t0 = time.perf_counter()
        hist = seq.fit(x, y, batch_size=bs, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    with recorded_masks(masks["cpu"]):
        host.fit(x, y, batch_size=bs, epochs=1, verbose=False)
    if len(masks["card"]) != 8 or len(masks["cpu"]) != 8 or not all(
            torch.equal(a.cpu(), b) for a, b in zip(masks["card"], masks["cpu"])):
        raise AssertionError("keras mnist: dropout masks differ card vs CPU")
    keep = float(torch.stack([m.float().mean() for m in masks["cpu"]]).mean())
    lc, lh = card.step_losses, host.step_losses
    if (len(lc) != 8 or not all(np.isfinite(lc)) or abs(lc[0] - lh[0]) > LOSS_RTOL * abs(lh[0])
            or any(abs(a - b) > 1e-4 * abs(b) for a, b in zip(lc, lh))):
        raise AssertionError(f"keras mnist: losses {lc} vs CPU {lh}")
    hp, cp = host.executor.params, card.executor.params
    for k_ in hp:
        for n_ in hp[k_]:
            moved = float((hp[k_][n_] - before[k_][n_]).abs().max())
            err = float((cp[k_][n_].detach().cpu() - hp[k_][n_].detach()).abs().max())
            if err > 1e-3 * moved:
                raise AssertionError(f"keras mnist: {k_}.{n_} differs by {err}, moved {moved}")
    mnist = {"steps": len(lc), "losses_card": lc, "losses_cpu": lh, "masks": len(masks["card"]),
             "mask_keep_share": keep, "accuracy": hist[0].accuracy, "fit_s": fit_s,
             "samples_per_s": 512 / fit_s,
             "param_max_abs_diff": max_tree_diff({k_: {n_: t.detach().cpu() for n_, t in g.items()}
                                                  for k_, g in cp.items()}, hp)}
    del seq, card, host

    # --- the functional CNN of tests/test_keras_frontend.py
    bs = 16
    inp = keras.Input(shape=(3, 16, 16))
    a = keras.Conv2D(8, 3, padding="same", activation="relu")(inp)
    b = keras.Conv2D(8, 3, padding="same", activation="relu")(inp)
    c = keras.Flatten()(keras.MaxPooling2D()(keras.Concatenate(axis=1)([a, b])))
    cnn = keras.Model(inp, keras.Dense(10, activation="softmax")(c))
    cnn.compile(optimizer=keras.Adam(learning_rate=0.001), loss="sparse_categorical_crossentropy",
                metrics=["accuracy"], config=FFConfig(batch_size=bs, seed=seed,
                                                      printing_interval=1000))
    cnn._ensure_built(bs)
    host = cpu_twin(cnn.ffmodel, cnn.optimizer.to_ff())
    xc = np.random.RandomState(seed).rand(64, 3, 16, 16).astype(np.float32)
    yc = np.random.RandomState(seed + 1).randint(0, 10, size=(64,)).astype(np.int32)
    eval_err = check_close("keras cnn eval (card vs CPU)", cnn.ffmodel.predict(xc[:bs]).cpu(),
                           host.predict(xc[:bs]))
    t0 = time.perf_counter()
    cnn.fit(xc, yc, epochs=1, batch_size=bs, verbose=False)
    torch.cuda.synchronize()
    cnn_fit_s = time.perf_counter() - t0
    host.fit(xc, yc, epochs=1, batch_size=bs, verbose=False)
    lc, lh = cnn.ffmodel.step_losses, host.step_losses
    if not all(np.isfinite(lc)) or abs(lc[0] - lh[0]) > LOSS_RTOL * abs(lh[0]):
        raise AssertionError(f"keras cnn: losses {lc} vs CPU {lh}")
    preds = cnn.predict(xc[:bs])
    if (preds.shape != (bs, 10) or not np.isfinite(preds).all()
            or float(np.abs(preds.sum(-1) - 1).max()) > 1e-5):
        raise AssertionError(f"keras cnn: predictions {preds.shape} not rows of probabilities")
    cnn_out = {"eval_max_abs_diff": eval_err, "losses_card": lc, "losses_cpu": lh,
               "predict_max_abs_diff_after_epoch": float(np.abs(preds - host.predict(
                   xc[:bs]).numpy()).max()), "fit_s": cnn_fit_s}
    del cnn, host
    torch.cuda.empty_cache()
    out = {"mnist_mlp": mnist, "functional_cnn": cnn_out, "phase_s": time.perf_counter() - t_phase}
    print("keras: " + json.dumps(out))
    return out


def resnet_forward_profile(model, x) -> dict:
    """``FFModel.profile`` of ResNet-50's forward (CUDA events around each
    op's second call, inference mode): the device ms by op type, the
    ops' total and the twelve slowest ops."""
    from flexflow_tpu_torch.runtime.profiling import format_profiles

    t0 = time.perf_counter()
    profs = model.profile(x=[x], verbose=False)
    profile_s = time.perf_counter() - t0
    by_type = {}
    for p in profs:
        agg = by_type.setdefault(p.op_type, {"ops": 0, "ms": 0.0, "gflop": 0.0})
        agg["ops"] += 1
        agg["ms"] += p.ms
        agg["gflop"] += p.flops / 1e9
    if not profs or not all(p.ms > 0 for p in profs):
        raise AssertionError("resnet profile: an op took no time")
    top = sorted(profs, key=lambda p: -p.ms)[:12]
    return {"ops": len(profs), "total_ms": sum(p.ms for p in profs), "profile_s": profile_s,
            "by_op_type": dict(sorted(by_type.items(), key=lambda kv: -kv[1]["ms"])),
            "top": [{"op": p.op_type, "name": p.name, "ms": p.ms, "tflops": p.tflops}
                    for p in top],
            "table_head": "\n".join(format_profiles(profs).splitlines()[:13])}


ONNX_BERT = dict(vocab=30522, layers=12, hidden=768, heads=12, ff=3072, classes=2)
ONNX_SEQ = 128
FX_BERT = dict(hidden=768, heads=12, ff_dim=3072, seq=128, layers=12)


def onnx_phase(seed: int) -> dict:
    """An ONNX BERT-Base served on the card through the flash forward.
    The fused encoder graph of ``flexflow_tpu_torch/tools/frontend_probe.py``
    (onnxruntime's transformer fusion: com.microsoft ``Attention`` nodes)
    at BERT-Base width (vocab 30522, 12 x 768, 12 heads, ff 3072, seq
    128, 2 classes: bert-cls's SST-2 head; weights from --seed at std
    0.02, LayerNorm scales 1; outputs ``logits`` and ``probs``), built by
    ``InferenceModel.from_onnx(max_batch=32)``, registered on an
    ``InferenceServer`` and served over ``/v2/models/bert_onnx/infer`` to
    16 client threads posting 64 requests of 1-4 rows. Gates: 4 rows'
    logits against a second ``from_onnx`` of the same proto on the CPU at
    ``max_batch=4`` (plain attention) within atol 1e-4 + rtol 1e-4; each
    response's outputs equal to ``infer`` on the same rows; 12
    ``ff_flash_fwd_f32`` launches a device batch and no other kernel;
    ``/metrics`` counting every request the clients received."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.serving import InferenceModel, InferenceServer
    from flexflow_tpu_torch.tools.frontend_probe import bert_onnx_graph

    t_phase = time.perf_counter()
    name, clients, requests, max_batch = "bert_onnx", 16, 64, 32
    layers, vocab = ONNX_BERT["layers"], ONNX_BERT["vocab"]
    t0 = time.perf_counter()
    proto = bert_onnx_graph(seed, **ONNX_BERT)
    graph_s = time.perf_counter() - t0
    kw = dict(input_shapes={"ids": (ONNX_SEQ,)}, name=name, input_dtypes={"ids": DataType.INT32})
    t0 = time.perf_counter()
    im = InferenceModel.from_onnx(proto, max_batch=max_batch, **kw)
    torch.cuda.synchronize()
    build_load_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed + 1)
    four = rs.randint(0, vocab, (4, ONNX_SEQ)).astype(np.int32)
    card4 = im.infer([four])[0]
    host = InferenceModel.from_onnx(proto, max_batch=4, device="cpu", **kw)
    cpu4 = host.infer([four])[0]
    del host, proto
    cpu_err = float(np.abs(card4 - cpu4).max())
    if not (np.isfinite(card4).all() and (np.abs(card4 - cpu4) <= ATOL + RTOL * np.abs(cpu4)).all()):
        raise AssertionError(f"onnx: card logits {card4} vs CPU {cpu4} beyond atol 1e-4 + rtol 1e-4")
    full = torch.from_numpy(rs.randint(0, vocab, (max_batch, ONNX_SEQ)).astype(np.int32)).cuda()
    batch_device_ms = profiled_device_ms(lambda: im.model.executor.predict([full]), iters=10)
    infer_host_ms = []  # host clock around infer of a full batch (it ends in a copy to the host)
    for _ in range(5):
        t0 = time.perf_counter()
        im.infer([full.cpu().numpy()])
        infer_host_ms.append((time.perf_counter() - t0) * 1e3)
    bodies = [rs.randint(0, vocab, (int(rs.randint(1, 5)), ONNX_SEQ)).astype(np.int32)
              for _ in range(requests)]
    results = [None] * requests
    server = InferenceServer(port=0)
    server.register(im)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        infer_post(base, name, bodies[0][:1], "ids")  # warm-up, not counted
        batcher = server.batchers[name]
        calls0, batched0 = batcher.device_calls, batcher.batched_requests
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        lock = threading.Lock()
        todo = list(range(requests))

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop(0)
                results[i] = infer_post(base, name, bodies[i], "ids")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise AssertionError("onnx: a client did not finish")
        launches = dict(fa.LAUNCHES)
        calls = batcher.device_calls - calls0
        batched = batcher.batched_requests - batched0
        metrics = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
    finally:
        server.stop()
    validate_exposition(metrics)
    unequal = 0
    for rows, res in zip(bodies, results):
        want = im.infer([rows])
        if len(res["outs"]) != 2 or not all(np.array_equal(g, w) for g, w in zip(res["outs"], want)):
            unequal += 1
    completed = re.search(r'flexflow_serving_requests_total\{model="%s",outcome="completed"\} '
                          r"(\d+)" % name, metrics)
    want_launches = {k: 0 for k in launches}
    want_launches["flash_fwd"] = layers * calls
    lat = sorted(r["latency_s"] for r in results)
    out = {
        "clients": clients, "requests": requests, "rows": sum(len(b) for b in bodies),
        "graph_s": graph_s, "build_and_load_s": build_load_s, "wall_s": wall,
        "requests_per_s": requests / wall, "rows_per_s": sum(len(b) for b in bodies) / wall,
        "latency_p50_s": lat[len(lat) // 2],
        "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "device_batches": calls, "requests_per_device_batch": batched / max(1, calls),
        "full_batch_device_ms": batch_device_ms, "full_batch_infer_host_ms": infer_host_ms,
        "launches": launches,
        "card_vs_cpu_max_abs_err": cpu_err, "responses_unequal_to_infer": unequal,
        "metrics_completed": int(completed.group(1)) if completed else None,
        "phase_s": time.perf_counter() - t_phase,
    }
    print("onnx (bert_onnx over /v2/models/bert_onnx/infer): " + json.dumps(out), flush=True)
    if unequal:
        raise AssertionError(f"onnx: {unequal} responses differ from infer on the same rows")
    if launches != want_launches:
        raise AssertionError(f"onnx: flash launches {launches}, expected {want_launches} "
                             f"({layers} forward launches a device batch)")
    if out["metrics_completed"] != requests + 1:
        raise AssertionError(f"onnx: /metrics counts {out['metrics_completed']} completed, "
                             f"the clients received {requests} + 1 warm-up")
    return out


def fx_encoder(hidden: int, heads: int, ff_dim: int, seq: int, layers: int):
    """``tests/test_torch_frontend.py``'s HF-style ``_BertEncoder``: q/k/v/o
    Linears with view/permute/matmul attention, post-LayerNorm residuals,
    a GELU MLP."""
    import torch
    import torch.nn as nn

    class SelfAttention(nn.Module):
        def __init__(self):
            super().__init__()
            self.q = nn.Linear(hidden, hidden)
            self.k = nn.Linear(hidden, hidden)
            self.v = nn.Linear(hidden, hidden)
            self.o = nn.Linear(hidden, hidden)
            self.heads, self.hd, self.seq, self.hidden = heads, hidden // heads, seq, hidden

        def forward(self, x):
            q = self.q(x).view(-1, self.seq, self.heads, self.hd).permute(0, 2, 1, 3)
            k = self.k(x).view(-1, self.seq, self.heads, self.hd).permute(0, 2, 1, 3)
            v = self.v(x).view(-1, self.seq, self.heads, self.hd).permute(0, 2, 1, 3)
            att = torch.matmul(q, k.transpose(-1, -2)) / (self.hd ** 0.5)
            att = torch.nn.functional.softmax(att, dim=-1)
            ctx = torch.matmul(att, v).permute(0, 2, 1, 3).reshape(-1, self.seq, self.hidden)
            return self.o(ctx)

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = SelfAttention()
            self.ln1 = nn.LayerNorm(hidden)
            self.ln2 = nn.LayerNorm(hidden)
            self.fc1 = nn.Linear(hidden, ff_dim)
            self.fc2 = nn.Linear(ff_dim, hidden)

        def forward(self, x):
            x = self.ln1(x + self.attn(x))
            h = self.fc2(torch.nn.functional.gelu(self.fc1(x)))
            return self.ln2(x + h)

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = nn.ModuleList([Layer() for _ in range(layers)])

        def forward(self, x):
            for layer in self.layers:
                x = layer(x)
            return x

    return Encoder()


def fx_phase(seed: int) -> dict:
    """The torch.fx importer training BERT-Base on the card. The HF-style
    encoder of tests/test_torch_frontend.py at BERT-Base width (12 x 768,
    12 heads, ff 3072, seq 128; fp32, TF32 off), traced by the port's
    ``PyTorchModel``, compiled with SGD 0.05 and MSE at batch 32 and
    given the module's weights by ``copy_weights``. Gates: ``predict``
    against the same module's own forward on the card (atol 1e-4 + rtol
    1e-4); the ``.ff`` export replayed into a fresh model predicting as
    the direct import (rtol 1e-5, atol 1e-6); four steps at batch 4 on the
    card against the same graph on the CPU from the same weights (the
    first loss rtol 1e-5, every loss rtol 1e-4, each parameter within
    1e-3 of the largest change). Then step ms and samples/s at batch 32.
    No hand-written kernel is on this path: the JAX package computes this
    attention (``torch.matmul`` and softmax) as batch_matmul and softmax
    in plain XLA, so the port runs them as torch ops."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import CompMode, LossType
    from flexflow_tpu_torch.frontends.torch import PyTorchModel, copy_weights, replay_ff
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime.optimizers import SGDOptimizer

    t_phase = time.perf_counter()
    batch, seq, hidden = 32, FX_BERT["seq"], FX_BERT["hidden"]
    torch.manual_seed(seed)
    module = fx_encoder(**FX_BERT).eval()
    rs = np.random.RandomState(seed + 2)

    def imported(bs, device=None, lr=0.05):
        ff = FFModel(FFConfig(batch_size=bs, seed=seed), device=device)
        pt = PyTorchModel(module)
        outs = pt.torch_to_ff(ff, [ff.create_tensor((bs, seq, hidden))])
        ff.compile(optimizer=SGDOptimizer(lr=lr), loss_type=LossType.MEAN_SQUARED_ERROR,
                   outputs=outs)
        copy_weights(module, ff, pt.name_map)
        return ff, pt

    t0 = time.perf_counter()
    card, pt = imported(batch)
    import_s = time.perf_counter() - t0
    x = torch.from_numpy(rs.randn(batch, seq, hidden).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.randn(batch, seq, hidden).astype(np.float32)).cuda()
    fa.reset_launch_counts()
    got = card.predict(x)
    with torch.no_grad():
        want = copy.deepcopy(module).cuda()(x)
    fwd_err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all()):
        raise AssertionError(f"fx: predict vs the module's forward differs by {fwd_err}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bert.ff")
        pt.export_ff(path, lambda: FFModel(FFConfig(batch_size=batch)), [(batch, seq, hidden)])
        ff_bytes = os.path.getsize(path)
        replayed = FFModel(FFConfig(batch_size=batch, seed=seed))
        outs = replay_ff(path, replayed, [replayed.create_tensor((batch, seq, hidden))])
    replayed.compile(comp_mode=CompMode.INFERENCE, outputs=outs)
    copy_weights(module, replayed, pt.name_map)
    again = replayed.predict(x)
    replay_err = float((again - got).abs().max())
    if not bool(((again - got).abs() <= 1e-6 + 1e-5 * got.abs()).all()):
        raise AssertionError(f"fx: the replayed .ff predicts {replay_err} away from the import")
    replay_bitwise = bool(torch.equal(again, got))
    del replayed, again
    # four steps at batch 4, card against CPU from the same weights
    x4, y4 = (rs.randn(4, seq, hidden).astype(np.float32) for _ in range(2))
    small, _ = imported(4)
    host, _ = imported(4, device="cpu")
    before = params_copy(host.executor.params)
    losses = {"card": [], "cpu": []}
    for tag, m, dev in (("card", small, "cuda"), ("cpu", host, "cpu")):
        xs, ys = torch.from_numpy(x4).to(dev), torch.from_numpy(y4).to(dev)
        for _ in range(4):
            losses[tag].append(float(m.executor.train_batch([xs], ys)["loss"]))
    lc, lh = np.array(losses["card"]), np.array(losses["cpu"])
    if not (np.isfinite(lc).all() and abs(lc[0] - lh[0]) <= LOSS_RTOL * abs(lh[0])
            and (np.abs(lc - lh) <= 1e-4 * np.abs(lh)).all()):
        raise AssertionError(f"fx: card losses {lc} vs CPU {lh}")
    a = host.executor.params
    # the two builds' guids differ: the card's weights by layer name
    b = {k: small.executor.params[small.executor.node_key(
        host.graph.nodes[int(k.rsplit("_", 1)[1])].name)] for k in a}
    leaves = [(k, n) for k in a for n in a[k]]
    with torch.no_grad():
        moved = max(float((a[k][n] - before[k][n]).abs().max()) for k, n in leaves)
        err = max(float((a[k][n] - b[k][n].cpu()).abs().max()) for k, n in leaves)
    if not 0 < moved or err > PARAM_STEP_RTOL * moved:
        raise AssertionError(f"fx: parameters differ by {err}, more than {PARAM_STEP_RTOL} of "
                             f"the largest change {moved}")
    del small, host, before
    # step time at batch 32
    ex = card.executor
    ex.train_batch([x], y)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        ex.train_batch([x], y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    out = {
        "batch": batch, "import_compile_copy_s": import_s, "predict_max_abs_err": fwd_err,
        "ff_file_bytes": ff_bytes, "replay_max_abs_err": replay_err,
        "replay_bitwise_equal": replay_bitwise, "losses_card": losses["card"],
        "losses_cpu": losses["cpu"], "param_max_abs_diff": err, "param_max_change": moved,
        "step_ms": step_ms, "samples_per_s": batch * 1e3 / float(np.median(step_ms)),
        "flash_launches": launches, "phase_s": time.perf_counter() - t_phase,
    }
    print("fx (HF-style BERT-Base by torch.fx): " + json.dumps(out), flush=True)
    if launches:
        raise AssertionError(f"fx: a flash kernel launched on a path that has none: {launches}")
    return out


def print_frontends(card: str, onnx: dict, fx: dict) -> None:
    """The onnx and fx lines of the summary."""
    if onnx:
        print(f"{card}: ONNX BERT-Base (12 x 768, seq 128, fused Attention) over "
              f"/v2/models/bert_onnx/infer ({onnx['clients']} clients, {onnx['requests']} "
              f"requests of 1-4 rows): {onnx['requests_per_s']:.2f} requests/s, client latency "
              f"p50 {onnx['latency_p50_s']:.4f} s, p99 {onnx['latency_p99_s']:.4f} s, "
              f"{onnx['requests_per_device_batch']:.2f} requests a device batch over "
              f"{onnx['device_batches']}; build and load {onnx['build_and_load_s']:.2f} s; device "
              f"ms of a full batch of 32 {onnx['full_batch_device_ms']:.3f}, host ms of its infer "
              + ", ".join(f"{ms:.2f}" for ms in onnx["full_batch_infer_host_ms"])
              + f"; card vs CPU logits "
              f"{onnx['card_vs_cpu_max_abs_err']:.2e}; phase {onnx['phase_s']:.1f} s")
    if fx:
        print(f"{card}: torch.fx BERT-Base (12 x 768, seq 128, batch 32, fp32): step ms "
              + ", ".join(f"{ms:.3f}" for ms in fx["step_ms"])
              + f", {fx['samples_per_s']:.2f} samples/s; predict vs module "
              f"{fx['predict_max_abs_err']:.2e}; .ff replay {fx['replay_max_abs_err']:.2e}; card "
              f"vs CPU losses {fx['losses_card'][-1]:.6f} vs {fx['losses_cpu'][-1]:.6f}; phase "
              f"{fx['phase_s']:.1f} s")


def print_moe_keras(card: str, moe: dict, keras_: dict, profile: dict) -> None:
    """The moe, keras and ResNet-50 per-op lines of the summary."""
    w = moe["window"]
    print(f"{card}: moe phase (examples/moe.py shape: 784 in, 8 experts, k 2, hidden 64, alpha "
          f"2.0, lambda_bal 0.04, batch 64, fp32): routing card vs CPU equal "
          f"({moe['routing']['dropped']} of {moe['routing']['slots']} slots dropped, smallest "
          f"top-k margin {moe['routing']['smallest_topk_margin']:.3e}); loss card "
          f"{moe['card_vs_cpu']['loss_b']:.6f} vs CPU {moe['card_vs_cpu']['loss_a']:.6f}; host ms "
          f"a step eager " + ", ".join(f"{ms:.3f}" for ms in w["host_ms_per_step"]["eager"])
          + " / window " + ", ".join(f"{ms:.3f}" for ms in w["host_ms_per_step"]["window"])
          + f"; device ms a step eager {w['device_ms_per_step']['eager']:.3f} / window "
          f"{w['device_ms_per_step']['window']:.3f}; busy share of the timed step eager "
          f"{w['busy_share_of_timed_step']['eager']:.3f} / window "
          f"{w['busy_share_of_timed_step']['window']:.3f}; capture s "
          + ", ".join(f"{c:.3f}" for c in w["capture_s"])
          + f"; window bit for bit {w['gate']['bitwise_equal']} with {w['captures']} capture; "
          f"batched vs per-expert {moe['batched_vs_per_expert']['max_abs_diff']:.2e}; recompile "
          f"{moe['recompile']['recompile_s']:.3f} s, weights kept bit for bit, "
          f"{moe['recompile']['captures_after']} capture after; elastic recovered bit for bit "
          f"{moe['elastic']['bitwise_equal']}; phase {moe['phase_s']:.1f} s")
    m, c = keras_["mnist_mlp"], keras_["functional_cnn"]
    print(f"{card}: keras phase: keras_mnist Sequential (784-128-10, dropout 0.2, batch 64, 512 "
          f"samples): masks bit for bit over {m['masks']} steps (keep {m['mask_keep_share']:.4f}),"
          f" loss {m['losses_card'][0]:.6f} -> {m['losses_card'][-1]:.6f} (CPU "
          f"{m['losses_cpu'][-1]:.6f}), parameters within {m['param_max_abs_diff']:.2e} of the "
          f"CPU's, {m['samples_per_s']:.1f} samples/s; functional CNN eval vs CPU "
          f"{c['eval_max_abs_diff']:.2e}, after the epoch {c['predict_max_abs_diff_after_epoch']:.2e}"
          f"; phase {keras_['phase_s']:.1f} s")
    print(f"{card}: ResNet-50 forward per op (FFModel.profile, batch 32, CUDA events, "
          f"{profile['ops']} ops, {profile['total_ms']:.3f} ms summed): by op type "
          + "; ".join(f"{t} {a['ms']:.3f} ms over {a['ops']}" for t, a in profile["by_op_type"]
                      .items()))
    print(profile["table_head"])


# the search phase's cells: BERT-Base bf16 (bench.py's cell, 12 x 768, 12
# heads, ff 3072, seq 128) at batch 32, SGD 0.01, MSE, 4 steps a build;
# the searched build's budget; the machine the card's owner does not have
SEARCH_BATCH = 32
SEARCH_STEPS = 4
SEARCH_BUDGET = 8
SEARCH_WORKERS = 8


def search_build(seed: int, cfg, **kw):
    """BERT-Base in ``cfg``'s dtype, weights from ``seed``, compiled with
    the FFConfig fields ``kw`` (the strategy's branch of compile)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.runtime import SGDOptimizer

    model = build_transformer(FFConfig(batch_size=SEARCH_BATCH, seed=seed, **kw), cfg)
    t0 = time.perf_counter()
    model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    return model, time.perf_counter() - t0


def named_params(model) -> dict:
    """The model's parameters by layer name (two builds' guids differ)."""
    from flexflow_tpu_torch.runtime.executor import node_key

    return {(n.name, w): p.detach().clone() for n in model.graph.topo_order() if n.name
            for w, p in model.executor.params.get(node_key(n), {}).items()}


def search_phase(seed: int) -> dict:
    """The Unity search on the card: calibrate the default suite through
    the port's ops (its attention entry through the bf16 flash forward),
    then a data-parallel and a searched build of BERT-Base bf16 trained 4
    steps each from the same weights, then a search for 8 H100s this
    machine does not have, its strategy file round trip and the
    device-count refusal of a compile that imports it."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import flexflow_tpu_torch._native as native
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.ops.base import get_op_def
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.parallel.strategy import ParallelStrategy
    from flexflow_tpu_torch.search import calibration as calib
    from flexflow_tpu_torch.search import simulator as sim
    from flexflow_tpu_torch.search.cost_model import CostModel
    from flexflow_tpu_torch.search.machine_model import build_machine_model
    from flexflow_tpu_torch.search.unity import predict_step_time, unity_optimize

    kind = torch.cuda.get_device_name(0)
    chip = calib.chip_spec_for(kind)
    if "h100" not in kind.lower() or chip.name != kind or chip.bf16_flops != 989e12:
        raise AssertionError(f"search: the card {kind!r} maps to {chip}, not the H100 spec")
    out = {"device_kind": kind, "chip": dict(vars(chip))}
    cache = tempfile.mkdtemp(prefix="ff_search_")
    prev_cache = os.environ.get("FLEXFLOW_TPU_TORCH_CACHE")
    os.environ["FLEXFLOW_TPU_TORCH_CACHE"] = cache  # the port's calibration cache, this run's
    launches = {}
    try:
        # 1. calibrate the default suite on the card
        suite = calib.default_suite()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        cal = calib.calibrate()
        out["calibrate_s"] = time.perf_counter() - t0
        launches["calibrate"] = {k: n for k, n in fa.LAUNCHES.items() if n}
        by_body = {k: n for k, n in fa.LAUNCHES_BY_BODY.items() if n}
        roof = CostModel(MachineSpec(num_nodes=1, devices_per_node=1, chip=chip))
        ratios = {}
        for op_type, params, specs in suite:
            key = calib.cost_key(op_type, params, specs, 1)
            if key not in cal.entries:
                raise AssertionError(f"calibrate: {op_type.name} not measured (failed {cal.failed})")
            c = get_op_def(op_type).cost(params, list(specs), get_op_def(op_type)
                                         .infer_output_specs(params, list(specs)))
            analytic = roof._roofline_time(c.flops, c.bytes_accessed, specs[0].dtype)
            label = f"{op_type.name} " + " ".join("x".join(map(str, s.shape)) for s in specs)
            ratios[label] = {"measured_s": cal.entries[key], "roofline_s": analytic,
                             "ratio": cal.entries[key] / analytic, "class": calib.op_class(op_type)}
            if not (np.isfinite(ratios[label]["ratio"]) and ratios[label]["ratio"] > 0):
                raise AssertionError(f"calibrate: {label} ratio {ratios[label]}")
        if cal.failed or len(cal.entries) != len(suite):
            raise AssertionError(f"calibrate: {len(cal.entries)} of {len(suite)} measured, "
                                 f"failed {cal.failed}")
        fwd = launches["calibrate"].get("flash_fwd_bf16", 0)
        if not fwd or by_body.get("flash_fwd_bf16 wgmma", 0) != fwd or set(
                launches["calibrate"]) != {"flash_fwd_bf16"}:
            raise AssertionError(f"calibrate: flash launches {launches['calibrate']}, by body "
                                 f"{by_body}: expected ff_flash_fwd_bf16 on the wgmma body only")
        reloaded = calib.load_calibration(kind)
        if reloaded is None or reloaded.to_json() != cal.to_json() or not reloaded.source.startswith(
                cache):
            raise AssertionError("calibrate: the saved table does not reload unchanged")
        out.update(ratios=ratios, derates=dict(cal.derates), table=reloaded.source)
        table_json = cal.to_json()

        # 2. BERT-Base bf16 on this card: data parallel, then searched
        cfg = bert_base(DataType.BFLOAT16)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        shape = (SEARCH_STEPS * SEARCH_BATCH, cfg.seq_length, cfg.hidden_size)
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        per_step = {f"{k}_bf16": cfg.num_layers for k in ("flash_fwd", "flash_bwd_dq",
                                                          "flash_bwd_dkv")}
        runs = {}
        for name, kw in (("data_parallel", {"only_data_parallel": True}),
                         ("searched", {"search_budget": SEARCH_BUDGET})):
            model, compile_s = search_build(seed, cfg, **kw)
            before = named_params(model)
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            model.fit(x, y, trace_window=1, verbose=False)
            got = {k: n for k, n in fa.LAUNCHES.items() if n}
            want = {k: n * SEARCH_STEPS for k, n in per_step.items()}
            if got != want:
                raise AssertionError(f"search {name}: flash launches {got}, expected {want}")
            launches[name] = got
            runs[name] = {"model": model, "compile_s": compile_s, "before": before,
                          "losses": list(model.step_losses), "after": named_params(model),
                          "step_ms": 1e3 * model.last_elapsed / SEARCH_STEPS}
        dp, sr = runs["data_parallel"], runs["searched"]
        res = sr["model"]._search_result
        if res is None or res.machine is None or res.machine.chip != chip or (
                res.calibration.device_kind != kind):
            raise AssertionError("search: compile(search_budget>0) did not run unity_optimize "
                                 "with the H100 spec and its calibration")
        axes = sr["model"].strategy.axis_sizes
        if any(v != 1 for v in axes.values()):
            raise AssertionError(f"search: one GPU, axes {axes}")
        same_graph = sr["model"].graph.structural_hash() == dp["model"].graph.structural_hash()
        if not same_graph:
            raise AssertionError("search: the one-GPU search rewrote the graph")
        if any(not torch.equal(dp["before"][k], sr["before"][k]) for k in dp["before"]) or (
                set(dp["before"]) != set(sr["before"])):
            raise AssertionError("search: the two builds start from different weights")
        if dp["losses"] != sr["losses"] or any(
                not torch.equal(dp["after"][k], sr["after"][k]) for k in dp["after"]):
            raise AssertionError(f"search: losses {dp['losses']} vs {sr['losses']} or the "
                                 "parameters differ after the steps")
        if not all(np.isfinite(dp["losses"])):
            raise AssertionError(f"search: losses {dp['losses']}")
        t0 = time.perf_counter()
        unity_optimize(sr["model"].graph, sr["model"].config)
        one_gpu_search_s = time.perf_counter() - t0
        predicted_sim = predict_step_time(sr["model"].graph, sr["model"].config, views=res.views,
                                          machine=res.machine, calibration=res.calibration)
        out["one_gpu"] = {
            "axes": axes, "search_s": one_gpu_search_s, "candidates": res.candidates_explored,
            "best_cost_ms": 1e3 * res.best_cost, "simulated_step_ms": 1e3 * predicted_sim,
            "measured_step_ms": {k: r["step_ms"] for k, r in runs.items()},
            "measured_over_predicted": sr["step_ms"] / (1e3 * res.best_cost),
            "compile_s": {k: r["compile_s"] for k, r in runs.items()},
            "losses": sr["losses"], "bitwise_equal": True, "same_graph": same_graph,
        }
        del runs, dp, sr, res
        torch.cuda.empty_cache()

        # 3. a search for 8 H100s, which this machine does not have
        cfg8 = FFConfig(batch_size=SEARCH_BATCH, seed=seed, search_budget=SEARCH_BUDGET,
                        search_num_workers=SEARCH_WORKERS, allreduce_optimize=True)
        graph = build_transformer(cfg8, cfg).graph
        native.reset_call_counts()
        replays0 = dict(sim.REPLAYS)
        t0 = time.perf_counter()
        st8, r8 = unity_optimize(graph, cfg8, machine=MachineSpec(
            num_nodes=1, devices_per_node=SEARCH_WORKERS, chip=chip))
        search8_s = time.perf_counter() - t0
        simulated8 = sim.Simulator(r8.machine, CostModel(r8.machine, calibration=r8.calibration),
                                   build_machine_model(r8.machine)).simulate(r8.graph, r8.views)
        calls = {k: n for k, n in native.CALLS.items() if n}
        replays = {k: sim.REPLAYS[k] - replays0[k] for k in replays0}
        lib = native._LIB_PATH
        if (not calls or replays["python"] or not replays["native"]
                or lib.parent.name != "_build" or not all(p.exists() for p in native._SOURCES)):
            raise AssertionError(f"search: native calls {calls}, replays {replays}, library {lib}")
        if r8.machine.num_devices != SEARCH_WORKERS or r8.machine.chip != chip:
            raise AssertionError(f"search: searched for {r8.machine}")
        fresh = build_transformer(cfg8, cfg).graph
        back = ParallelStrategy.from_json(st8.to_json()).remap_to(fresh)
        if back is None:
            raise AssertionError("search: the 8-GPU strategy does not remap onto a fresh build")

        def by_name(st):
            return {st.node_names[g]: (sh.outputs, sh.weights, sh.machine_view)
                    for g, sh in st.node_shardings.items()}
        if back.axis_sizes != st8.axis_sizes or by_name(back) != by_name(st8):
            raise AssertionError("search: to_json -> from_json -> remap_to changed the strategy")
        need = 1
        for v in st8.axis_sizes.values():
            need *= v
        path, exported = os.path.join(cache, "strategy8.json"), os.path.join(cache, "again.json")
        with open(path, "w") as f:
            f.write(st8.to_json())
        m = build_transformer(FFConfig(batch_size=SEARCH_BATCH, seed=seed, import_strategy_file=path,
                                       export_strategy_file=exported), cfg)
        fa.reset_launch_counts()
        try:
            m.compile()
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("search: a compile importing the 8-GPU strategy did not raise")
        if (refusal != f"mesh needs {need} devices, have 1" or m.executor is not None
                or any(fa.LAUNCHES.values()) or not os.path.exists(exported)):
            raise AssertionError(f"search: the import raised {refusal!r} (executor "
                                 f"{m.executor}, launches {dict(fa.LAUNCHES)})")
        out["eight_gpus"] = {
            "axes": st8.axis_sizes, "search_s": search8_s, "candidates": r8.candidates_explored,
            "best_cost_ms": 1e3 * r8.best_cost, "simulated_step_ms": 1e3 * simulated8,
            "memory_per_device_gb": r8.memory_per_device / 1e9, "pipeline": r8.pipeline,
            "context_parallel": r8.context_parallel, "context_parallel_tp": r8.context_parallel_tp,
            "allreduce_saved_ms": 1e3 * r8.allreduce_saved, "native_calls": calls,
            "replays": replays, "native_build_s": native.last_build_seconds,
            "refusal": refusal,
        }
    finally:
        if prev_cache is None:
            os.environ.pop("FLEXFLOW_TPU_TORCH_CACHE", None)
        else:
            os.environ["FLEXFLOW_TPU_TORCH_CACHE"] = prev_cache
        shutil.rmtree(cache, ignore_errors=True)
    out["launches"] = {name: sum(run.get(name, 0) for run in launches.values())
                       for name in fa.LAUNCHES}
    out["launches_by_run"] = launches
    print("search: " + json.dumps(out))
    out["table_json"] = table_json  # the programs phase's calibration (not printed)
    return out


def print_search(card: str, s: dict) -> None:
    print(f"{card}: calibration ({s['device_kind']}, {s['calibrate_s']:.2f} s), measured over "
          "roofline: " + "; ".join(f"{k} {r['ratio']:.3f} ({r['measured_s'] * 1e3:.4f} ms)"
                                   for k, r in s["ratios"].items())
          + "; derates " + ", ".join(f"{c} {d:.4f}" for c, d in s["derates"].items()))
    o = s["one_gpu"]
    print(f"{card}: searched BERT-Base bf16 (batch 32, budget 8) on one GPU: axes {o['axes']}, "
          f"search {o['search_s']:.3f} s, {o['candidates']} candidates; predicted step "
          f"{o['best_cost_ms']:.3f} ms (task-graph simulator {o['simulated_step_ms']:.3f}), "
          f"measured {o['measured_step_ms']['searched']:.3f} (data parallel "
          f"{o['measured_step_ms']['data_parallel']:.3f}), measured / predicted "
          f"{o['measured_over_predicted']:.3f}; losses bit for bit {o['losses']}")
    e = s["eight_gpus"]
    print(f"{card}: search for 8 H100s (budget 8): axes {e['axes']}, best cost "
          f"{e['best_cost_ms']:.4f} ms (task-graph simulator {e['simulated_step_ms']:.4f}), "
          f"{e['candidates']} candidates, {e['search_s']:.2f} s, memory a device "
          f"{e['memory_per_device_gb']:.3f} GB; native calls {e['native_calls']}; "
          f"import refused: {e['refusal']}")


# ---------------------------------------------------------------- programs
PROGRAMS_STEPS, PROGRAMS_TW = 16, 8  # the registry leg: 16 steps, two windows of 8
CAPI_LEG = {"width": 768, "heads": 12, "seq": 128, "batch": 8, "layers": 2, "steps": 3}


def lcg_values(state: int, n: int) -> tuple:
    """(next state, ``n`` values in [-1, 1)) of the C driver's LCG."""
    out = []
    for _ in range(n):
        state = (state * 1103515245 + 12345) & 0xFFFFFFFF
        out.append(((state >> 16 & 0x7FFF) / 32768.0 - 0.5) * 2.0)
    return state, out


def c_driver_reference(device: str, leg: dict) -> list:
    """The C driver's MHA leg through the Python API in this process:
    the same layers, data and steps; its losses."""
    import numpy as np

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import ActiMode, LossType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import SGDOptimizer

    b, s, w = leg["batch"], leg["seq"], leg["width"]
    m = FFModel(FFConfig(batch_size=b), device=device)
    t = m.create_tensor((b, s, w), name="x")
    for _ in range(leg["layers"]):
        t = m.multihead_attention(t, t, t, w, leg["heads"], name="")
    m.dense(t, w, ActiMode.NONE, name="head")
    m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    state, xv = lcg_values(777, b * s * w)
    _, yv = lcg_values(state, b * s * w)
    x = np.asarray(xv).reshape(b, s, w).astype(np.float32)
    y = np.asarray(yv).reshape(b, s, w).astype(np.float32)
    return [float(m.executor.train_batch([x], y)["loss"]) for _ in range(leg["steps"])]


def build_c_driver(out_dir: str) -> str:
    """Compile the port's C driver against the port's ``libffcore.so``
    (built at the native module's import) and libpython; its path."""
    import shutil
    import sysconfig

    import flexflow_tpu_torch._native as native

    repo = os.path.dirname(os.path.abspath(__file__))
    libdir = str(native._BUILD_DIR)
    pylib = sysconfig.get_config_var("LIBDIR")
    exe = os.path.join(out_dir, "c_model_driver")
    cc = shutil.which(os.environ.get("CC", "gcc")) or shutil.which("cc")
    if cc is None:
        raise AssertionError("programs: no C compiler for the C driver")
    subprocess.run([cc, "-O1", os.path.join(repo, "flexflow_tpu_torch", "_native", "src",
                                            "c_model_driver.c"),
                    "-I", os.path.join(repo, "native", "include"),
                    "-I", sysconfig.get_path("include"), "-L", libdir, "-lffcore",
                    "-L", pylib, f"-lpython{sysconfig.get_config_var('LDVERSION')}",
                    f"-Wl,-rpath,{libdir}", f"-Wl,-rpath,{pylib}", "-o", exe],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def parse_c_driver(stdout: str) -> dict:
    """The C driver's losses by leg, its OK lines and its launch counts."""
    out = {"mlp": [], "mha": [], "ok": [], "launches": None}
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[1] == "step" and parts[0] in ("mlp", "mha"):
            out[parts[0]].append(float(parts[4]))
        elif line.startswith(("C_MODEL_OK", "C_MHA_OK")):
            out["ok"].append(parts[0])
        elif line.startswith("FLASH_LAUNCHES "):
            out["launches"] = json.loads(line[len("FLASH_LAUNCHES "):])
    return out


def programs_phase(seed: int, table_json: str) -> dict:
    """The executor's programs and measured steps, then the card's
    profiling and evidence tools, the C API and the DataLoader's native
    gather. ``table_json`` is the search phase's H100 calibration table,
    written into this phase's own calibration cache."""
    import shutil
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    import flexflow_tpu_torch._native as native
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.obs.capacity import GLOBAL_PROGRAMS
    from flexflow_tpu_torch.obs.truth import GLOBAL_LEDGER
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import SGDOptimizer
    from flexflow_tpu_torch.search import calibration as calib
    from flexflow_tpu_torch.serving import InferenceServer
    from flexflow_tpu_torch.tools import calib_debug

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    work = tempfile.mkdtemp(prefix="ff_programs_")
    cache = os.path.join(work, "cache")
    os.makedirs(cache)
    with open(os.path.join(cache, f"opcosts_{calib._slug(kind)}.json"), "w") as f:
        f.write(table_json)
    prev_cache = os.environ.get("FLEXFLOW_TPU_TORCH_CACHE")
    os.environ["FLEXFLOW_TPU_TORCH_CACHE"] = cache
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    out, launches, seconds = {}, {}, {}
    try:
        # (a) the registry and the ledger: BERT-Base bf16, 16 steps as two windows of 8
        t0 = time.perf_counter()
        cfg = bert_base(DataType.BFLOAT16)
        batch = 32
        model = build_transformer(FFConfig(batch_size=batch, seed=seed), cfg)
        model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
        ex = model.executor
        ns = ex._prog_ns
        gen = torch.Generator(device="cuda").manual_seed(seed + 41)
        shape = (PROGRAMS_STEPS * batch, cfg.seq_length, cfg.hidden_size)
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        fa.reset_launch_counts()
        model.fit(x, y, epochs=1, trace_window=PROGRAMS_TW, verbose=False)
        launches["registry"] = {k: n for k, n in fa.LAUNCHES.items() if n}
        progs = {e["name"]: e for e in GLOBAL_PROGRAMS.snapshot() if e["name"].startswith(ns + ".")}
        window = progs.get(f"{ns}.train_window[{PROGRAMS_TW}]")
        if (window is None or window["traces"] != 1 or set(progs) != {window["name"]}
                or ex.graph_captures != 1
                or any(r["program"].startswith(ns + ".") for r in GLOBAL_PROGRAMS.recent_retraces())):
            raise AssertionError(f"programs: registry {progs}, captures {ex.graph_captures}: "
                                 f"expected one train_window[{PROGRAMS_TW}] capture")
        entry = next((e for e in GLOBAL_LEDGER.report()["entries"]
                      if e["key"] == f"{ns}.train_step"), None)
        if (entry is None or not entry["predicted_s"] > 0 or entry["pairs"] < 1
                or cache not in entry["provenance"]):
            raise AssertionError(f"programs: ledger entry {entry}: expected a prediction from "
                                 "the card's table and a measured pair")
        want = {f"flash_{k}_bf16": PROGRAMS_STEPS * cfg.num_layers
                for k in ("fwd", "bwd_dq", "bwd_dkv")}
        if launches["registry"] != want:
            raise AssertionError(f"programs: launches {launches['registry']}, expected {want}")
        srv = InferenceServer(port=0)
        srv.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v2/debug/programs",
                                        timeout=60) as r:
                listed = json.loads(r.read())
        finally:
            srv.stop()
        names = {e["name"] for e in listed.get("executor", {}).get("programs", [])}
        if window["name"] not in names:
            raise AssertionError(f"programs: /v2/debug/programs lists {sorted(names)}")
        out["registry"] = {
            "program": window["name"].replace(ns, "executor[n]"), "traces": window["traces"],
            "capture_s": window["compile_s"], "signature": window["signature"],
            "predicted_step_ms": entry["predicted_s"] * 1e3,
            "measured_step_ms_p50": entry["measured_p50_s"] * 1e3, "pairs": entry["pairs"],
            "rel_err_p50": entry["rel_err_p50"], "provenance": entry["provenance"],
            "fit_s": model.last_elapsed,
        }
        del model, ex, x, y
        torch.cuda.empty_cache()
        seconds["a"] = time.perf_counter() - t0

        # (b) mfu_profile as a child: BERT-Base bf16, batch 32, 8 steps a window
        t0 = time.perf_counter()
        mfu_out = os.path.join(work, "MFU_PROFILE.json")
        proc = subprocess.run([sys.executable, "-m", "flexflow_tpu_torch.tools.mfu_profile",
                               "--batch", "32", "--iters", "8", "--out", mfu_out],
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"programs: mfu_profile exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        with open(mfu_out) as f:
            prof = json.load(f)["runs"][-1]
        br = prof["breakdown"]
        flash_ops = [o["op"] for o in br.get("top_ops", []) if o["category"] == "flash"]
        bf16 = {k: n for k, n in prof["flash_launches"].items() if k.endswith("_bf16")}
        if (len(bf16) != 3 or not flash_ops
                or abs(sum(br["category_us"].values()) - br["total_device_us"])
                > 0.01 * br["total_device_us"] or prof["peak_flops"] != 989e12):
            raise AssertionError(f"programs: mfu_profile entry {prof}")
        out["mfu_profile"] = {k: prof[k] for k in ("step_ms", "mfu", "prediction", "breakdown",
                                                   "flash_launches", "device_kind")}
        seconds["b"] = time.perf_counter() - t0

        # (c) calib_debug's steps A-E on the card
        t0 = time.perf_counter()
        cd = calib_debug.run(torch.device("cuda"))["steps"]
        figures = [cd["launch_floor_us"], *cd["launch_jitter_us"], cd["matmul_per_iter_us"],
                   cd["matmul_achieved_tflops"], cd["ln_per_iter_us"], cd["ln_effective_gbps"],
                   cd["framework_linear_us"], cd["framework_ln_us"],
                   *cd["matmul_loop_s"].values(), *cd["ln_loop_s"].values()]
        if (not all(v is not None and np.isfinite(v) and v > 0 for v in figures)
                or not all(np.isfinite(cd[k]) for k in ("matmul_fixed_overhead_us",
                                                        "ln_fixed_overhead_us"))
                or set(cd["prediction_error"]) != {"linear", "ln"}):
            raise AssertionError(f"programs: calib_debug steps {cd}")
        out["calib_debug"] = cd
        seconds["c"] = time.perf_counter() - t0

        # (d) evidence.py --quick: one lever lands, a rerun skips it, a
        # child killed by its timeout leaves the file valid
        t0 = time.perf_counter()
        ev = os.path.join(work, "evidence.json")
        ev_cmd = [sys.executable, "-m", "flexflow_tpu_torch.tools.evidence", "--quick",
                  "--iters", "8"]
        runs = []
        for path, extra in ((ev, []), (ev, []), (os.path.join(work, "killed.json"),
                                                 ["--child-timeout", "2"])):
            proc = subprocess.run(ev_cmd + ["--out", path] + extra, env=env,
                                  capture_output=True, text=True, timeout=600)
            with open(path) as f:
                runs.append((proc.returncode, json.load(f)["runs"]))
        (rc1, r1), (rc2, r2), (rc3, r3) = runs
        lever = [r for r in r1 if r.get("phase") == "lever"]
        if (rc1 != 0 or len(lever) != 1 or lever[0]["config"] != "bert_base_b32_dp"
                or not lever[0].get("step_ms", 0) > 0 or rc2 != 0 or r2 != r1
                or rc3 != 0 or [r.get("error", "")[:7] for r in r3] != ["timeout"]):
            raise AssertionError(f"programs: evidence runs {runs}")
        out["evidence"] = {"lever": lever[0], "killed": r3}
        seconds["d"] = time.perf_counter() - t0

        # (e) the C driver on the card: the MLP loop, then the MHA leg at
        # BERT-Base width; its losses against the Python API's here
        t0 = time.perf_counter()
        exe = build_c_driver(work)
        leg = CAPI_LEG
        proc = subprocess.run([exe, "cuda", *(str(leg[k]) for k in (
            "width", "heads", "seq", "batch", "layers", "steps"))],
            env=env, capture_output=True, text=True, timeout=600)
        cd_out = parse_c_driver(proc.stdout)
        if proc.returncode != 0 or cd_out["ok"] != ["C_MODEL_OK", "C_MHA_OK"]:
            raise AssertionError(f"programs: C driver exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        n_bwd = leg["steps"] * leg["layers"]
        cl = cd_out["launches"] or {}
        if (cl.get("flash_bwd_dq") != n_bwd or cl.get("flash_bwd_dkv") != n_bwd
                or cl.get("flash_fwd", 0) < n_bwd or not cd_out["mha"][-1] < cd_out["mha"][0]):
            raise AssertionError(f"programs: C driver launches {cl}, losses {cd_out['mha']}")
        fa.reset_launch_counts()
        ref = c_driver_reference("cuda", leg)
        launches["c_api_reference"] = {k: n for k, n in fa.LAUNCHES.items() if n}
        if not all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(cd_out["mha"], ref)) or len(
                ref) != len(cd_out["mha"]):
            raise AssertionError(f"programs: C driver losses {cd_out['mha']} vs the Python "
                                 f"API's {ref}")
        out["c_api"] = {"mlp_losses": cd_out["mlp"], "mha_losses": cd_out["mha"],
                        "python_losses": ref, "launches": cl, "leg": leg}
        seconds["e"] = time.perf_counter() - t0

        # (f) the DataLoader's native gather: fp32 BERT-Base, shuffled
        t0 = time.perf_counter()
        cfg = bert_base(DataType.FLOAT)
        model = build_transformer(FFConfig(batch_size=batch, seed=seed), cfg)
        model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
        ex = model.executor
        n = 8 * batch
        rs = np.random.RandomState(seed + 5)
        hx = torch.from_numpy(rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32))
        hy = torch.from_numpy(rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32))
        loader = model.create_data_loader(hx, hy, batch_size=batch, shuffle=True, seed=seed)
        order = np.random.RandomState(seed).permutation(n)
        native.reset_call_counts()
        batches = list(loader.epoch())
        gathers = native.CALLS["batch_gather"]
        for i, (ins, lab) in enumerate(batches):
            idx = torch.from_numpy(order[i * batch:(i + 1) * batch])
            if not (torch.equal(ins[0].cpu(), torch.index_select(hx, 0, idx))
                    and torch.equal(lab.cpu(), torch.index_select(hy, 0, idx))):
                raise AssertionError(f"programs: the loader's batch {i} differs from "
                                     "index_select's")
        if gathers < 2 * len(batches) or len(batches) != 8:
            raise AssertionError(f"programs: {gathers} native gathers for {len(batches)} batches")
        del batches
        fa.reset_launch_counts()

        def from_loader():
            return [float(ex.train_batch(i, lab)["loss"]) for i, lab in loader.epoch()]

        staged_x = [hx[torch.from_numpy(order[i * batch:(i + 1) * batch])].cuda() for i in range(8)]
        staged_y = [hy[torch.from_numpy(order[i * batch:(i + 1) * batch])].cuda() for i in range(8)]

        def staged():
            return [float(ex.train_batch([a], b)["loss"]) for a, b in zip(staged_x, staged_y)]

        timed = {"loader": [], "staged": []}
        for name in ("loader", "staged", "staged", "loader"):  # in turns
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (from_loader if name == "loader" else staged)()
            torch.cuda.synchronize()
            timed[name].append(1e3 * (time.perf_counter() - t1) / 8)
        wall, busy = busy_share(from_loader)
        launches["dataloader"] = {k: n for k, n in fa.LAUNCHES.items() if n}
        out["dataloader"] = {"gathers": gathers, "loader_ms_per_step": timed["loader"],
                             "staged_ms_per_step": timed["staged"],
                             "loader_busy_share": busy / wall}
        del model, ex, loader, staged_x, staged_y
        torch.cuda.empty_cache()
        seconds["f"] = time.perf_counter() - t0
    finally:
        if prev_cache is None:
            os.environ.pop("FLEXFLOW_TPU_TORCH_CACHE", None)
        else:
            os.environ["FLEXFLOW_TPU_TORCH_CACHE"] = prev_cache
        shutil.rmtree(work, ignore_errors=True)
    out["launches_by_leg"] = launches
    out["launches"] = {name: sum(leg_.get(name, 0) for leg_ in launches.values())
                       for name in fa.LAUNCHES}
    out["seconds"] = seconds
    out["phase_s"] = time.perf_counter() - t_phase
    print("programs: " + json.dumps(out))
    return out


def print_programs(card: str, p: dict) -> None:
    r = p["registry"]
    print(f"{card}: executor programs, BERT-Base bf16 (batch 32, seq 128) fit as two windows of "
          f"8: {r['program']} traced {r['traces']}x (capture {r['capture_s']:.3f} s); step "
          f"predicted {r['predicted_step_ms']:.3f} ms, measured p50 "
          f"{r['measured_step_ms_p50']:.3f} ms over {r['pairs']} pair(s) (rel err "
          f"{r['rel_err_p50']:.3f}; PR 24's private path: 11.6-11.8 predicted, 57.8-81.1 "
          f"measured)")
    m = p["mfu_profile"]
    br = m["breakdown"]
    print(f"{card}: mfu_profile BERT-Base bf16 batch 32: step {m['step_ms']:.3f} ms, MFU "
          f"{m['mfu']:.4f} of 989 TFLOP/s; device us {br['total_device_us']:.1f} by group "
          + ", ".join(f"{k} {us:.1f}" for k, us in br["category_us"].items())
          + "; top " + "; ".join(f"{o['op'][:60]} {o['us']:.1f}" for o in br["top_ops"][:6]))
    c = p["calib_debug"]
    print(f"{card}: calib_debug: launch floor {c['launch_floor_us']:.3f} us (jitter "
          f"{min(c['launch_jitter_us']):.3f}-{max(c['launch_jitter_us']):.3f}); matmul "
          f"{c['matmul_per_iter_us']:.3f} us a call ({c['matmul_achieved_tflops']:.1f} TFLOP/s, "
          f"fixed {c['matmul_fixed_overhead_us']:.3f} us); LayerNorm {c['ln_per_iter_us']:.3f} "
          f"us a call ({c['ln_effective_gbps']:.1f} GB/s, fixed {c['ln_fixed_overhead_us']:.3f} "
          "us); framework " + "; ".join(
              f"{k} predicted {e['predicted_us']:.3f} us, measured {e['measured_p50_us']:.3f}"
              for k, e in c["prediction_error"].items()))
    e = p["evidence"]["lever"]
    print(f"{card}: evidence --quick lever bert_base_b32_dp: step {e['step_ms']:.3f} ms, "
          f"{e['samples_per_s']:.1f} samples/s, MFU {e['mfu']:.4f}")
    a = p["c_api"]
    print(f"{card}: C driver: MLP losses {a['mlp_losses']}; MHA leg ({a['leg']}) losses "
          f"{a['mha_losses']} vs the Python API's {a['python_losses']}; launches "
          + json.dumps({k: v for k, v in a["launches"].items() if v}))
    d = p["dataloader"]
    print(f"{card}: DataLoader, fp32 BERT-Base batch 32, native gather ({d['gathers']} calls): "
          "ms a step " + ", ".join(f"{x:.3f}" for x in d["loader_ms_per_step"])
          + " vs staged " + ", ".join(f"{x:.3f}" for x in d["staged_ms_per_step"])
          + f" (PR 20: 78.4-104.9, staged 66.1-74.7), busy share {d['loader_busy_share']:.3f}")
    print(f"{card}: programs phase {p['phase_s']:.1f} s (" + ", ".join(
        f"{k} {s:.1f}" for k, s in p["seconds"].items()) + ")")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed for weights, prompts and inputs")
    ap.add_argument("--durable-child", metavar="WAL_DIR",
                    help="serve leg 1 of the durable phase from WAL_DIR (started by the "
                         "durable phase itself, which kills it)")
    ap.add_argument("--resume-child", metavar="CKPT_DIR",
                    help="resume the checkpoint cell from CKPT_DIR (started by the trainer "
                         "phase itself)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.ops.kernels import _build

    # full fp32 everywhere: TF32 would move the logits past the checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS's 2-byte split-K reductions stay at PyTorch's default, as the
    # port runs them: the BERT-Base steps take no split-K GEMM, and turning
    # them off changes no bit of a step (tools/reduction_probe.py)
    if args.durable_child:
        return durable_child(args.seed, args.durable_child)
    if args.resume_child:
        return resume_child(args.seed, args.resume_child)

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s)")
    for kernel, info in ptxas_report(_build.last_build_log):
        print(f"  ptxas: {kernel}: {info}")
    hmma, hgmma = tensor_core_check()
    print("tensor cores: HMMA instructions in the SASS of " + json.dumps(hmma))
    print("tensor cores: HGMMA (wgmma) instructions in the SASS of " + json.dumps(hgmma))
    lib = _build.load_library()
    print("bf16 wgmma bodies (the fp16 ones hold the same registers and shared memory), "
          "blocks an SM (occupancy calculator): " + json.dumps({
        f"{kernel}<{d}>": lib.ff_flash_wg_blocks_per_sm(kind, d)
        for kernel, kind in (("flash_fwd_wg_kernel", 0), ("flash_bwd_dq_wg_kernel", 1),
                             ("flash_bwd_dkv_wg_kernel", 2))
        for d in (64, 128)}))

    rows = kernel_phase(args.seed)
    params = init_decoder_params(torch.Generator().manual_seed(args.seed), gpt2_small())
    params = params_to(params, "cuda")  # one copy on the card, shared by every engine
    engines, serving, cell = serving_phase(args.seed, params)
    kv_dtype = kv_dtype_phase(args.seed, params, cell, engines["graph"])
    long_ctx, long_engine = long_context_phase(args.seed, params)
    graphs = step_graph_phase(engines, args.seed)
    speculation = speculation_phase(args.seed, params)
    prefix = prefix_phase(args.seed, params)
    overlap = overlap_phase(args.seed, params)
    constrained = constrained_phase(args.seed, params)
    server = server_phase(args.seed, params)
    durable = durable_phase(args.seed, params, cell)
    fleet = fleet_phase(args.seed, params, cell, prefix.pop("cell"))
    tools = tools_phase(args.seed, params, card)
    anatomy = anatomy_phase(engines, args.seed)
    long_ctx["profiled"] = long_context_profile(long_engine, args.seed)
    suffix_bodies = suffix_prefill_bodies(args.seed, params)
    del engines, long_engine, params
    torch.cuda.empty_cache()
    flash = flash_phase(args.seed)
    training = training_phase(args.seed)
    training_bf16 = training_phase(args.seed, DataType.BFLOAT16)
    training_f16 = training_phase(args.seed, DataType.HALF)
    heads = {}
    heads["bert-cls"], cls_model, _ = heads_phase(args.seed, "bert-cls")
    heads["infer"] = infer_phase(args.seed, cls_model)
    del cls_model
    torch.cuda.empty_cache()
    heads["bert-cls bf16"] = heads_phase(args.seed, "bert-cls", DataType.BFLOAT16)[0]
    torch.cuda.empty_cache()
    heads["bert-mlm"] = heads_phase(args.seed, "bert-mlm", steps=5)[0]
    torch.cuda.empty_cache()
    heads["seq2seq"] = heads_phase(args.seed, "seq2seq", steps=5)[0]
    torch.cuda.empty_cache()
    fp32_heads = ("bert-cls", "bert-mlm", "seq2seq", "infer")
    trainer = {"fp32": trainer_phase(args.seed), "bf16": trainer_phase(args.seed, DataType.BFLOAT16)}
    trainer["checkpoint"] = checkpoint_phase(args.seed)
    vision = vision_phase(args.seed)
    torch.cuda.empty_cache()
    window = window_phase(args.seed)
    moe = moe_phase(args.seed)
    keras_ = keras_phase(args.seed)
    torch.cuda.empty_cache()
    onnx_ = onnx_phase(args.seed)
    torch.cuda.empty_cache()
    fx_ = fx_phase(args.seed)
    torch.cuda.empty_cache()
    search = search_phase(args.seed)
    torch.cuda.empty_cache()
    programs = programs_phase(args.seed, search.pop("table_json"))

    def trainer_launches(name):  # the trainer and window phases' launches of a flash form
        return (sum(sum(r["launches"][k][name] for k in r["launches"])
                    for r in (trainer["fp32"], trainer["bf16"]))
                + trainer["checkpoint"]["launches"][name]
                + sum(window[c]["launches"].get(name, 0) for c in ("bert-base fp32",
                                                                   "bert-base bf16")))

    def record(name, replaces, row, launches, source=SOURCE):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    def single(form):  # the single-pass rows of a cache form
        return [r for name, r in rows.items()
                if r["shape"]["splits"] == 1 and name.endswith(form)
                and r["shape"]["kv_dtype"] == {"": "float32", "_bf16": "bfloat16",
                                               "_f16": "float16"}[form]]

    kernels = [
        record("paged_append", "flexflow_tpu/ops/kernels/decode_attention.py:368",
               dict(rows["decode"], max_abs_err=max(r["max_abs_err"] for r in single(""))),
               serving["launches"]["paged_append"] + speculation["launches"]["paged_append"]
               + prefix["launches"]["paged_append"] + overlap["launches"]["paged_append"]
               + constrained["launches"]["paged_append"] + server["launches"]["paged_append"]
               + durable["launches"]["paged_append"] + fleet["launches"]["paged_append"]
               + tools["launches"]["paged_append"]
               + suffix_bodies["float"]["launches"]["paged_append"]),
        record("paged_append_split", "flexflow_tpu/ops/kernels/decode_attention.py:338",
               rows["split"], long_ctx["launches"]["paged_append_split"]),
    ] + [
        record(name, f"flexflow_tpu/ops/kernels/flash_attention.py:{line}",
               dict(flash["train"][name], max_abs_err=max(
                   flash["train"][name]["max_abs_err"], flash["causal512"][name]["max_abs_err"])),
               training["launches"][name]
               + sum(heads[cell]["launches"][name] for cell in fp32_heads)
               + trainer_launches(name) + onnx_["launches"][name]
               + programs["launches"][name], FLASH_SOURCE)
        for name, line in (("flash_fwd", 158), ("flash_bwd_dq", 262), ("flash_bwd_dkv", 278))
    ] + [
        record(f"{name}{form}", f"flexflow_tpu/ops/kernels/flash_attention.py:{line}",
               dict(flash["train"][f"{name}{form}"], max_abs_err=max(
                   flash["train"][f"{name}{form}"]["max_abs_err"],
                   flash["causal512"][f"{name}{form}"]["max_abs_err"])),
               run["launches"][f"{name}{form}"]
               + (heads["bert-cls bf16"]["launches"][f"{name}{form}"] + search["launches"][
                   f"{name}{form}"] + programs["launches"][f"{name}{form}"]
                  if form == "_bf16" else 0)
               + trainer_launches(f"{name}{form}"), FLASH_SOURCE)
        for form, run in (("_bf16", training_bf16), ("_f16", training_f16))
        for name, line in (("flash_fwd", 158), ("flash_bwd_dq", 262), ("flash_bwd_dkv", 278))
    ] + [
        record(f"{kernel}{form}", f"flexflow_tpu/ops/kernels/decode_attention.py:{line}",
               dict(rows[case + form], max_abs_err=max(r["max_abs_err"] for r in (
                   single(form) if kernel == "paged_append" else [rows[case + form]]))),
               kv_dtype["launches"][kernel + form]
               + suffix_bodies[ctype]["launches"][kernel + form])
        for form, ctype in (("_bf16", "__nv_bfloat16"), ("_f16", "__half"))
        for kernel, case, line in (("paged_append", "decode", 368),
                                   ("paged_append_split", "split", 338))
    ]
    for t in (training, training_bf16, training_f16):
        print(f"{card}: BERT-Base training (12 x 768, seq 128, batch 32), {t['dtype']}: "
              f"{t['samples_per_s']:.2f} samples/s, step {t['step_ms']:.3f} ms, device ms a step "
              f"{t['step_device_ms']:.3f} (" + ", ".join(
                  f"{g} {ms:.3f}" for g, ms in t["step_device_ms_by_group"].items())
              + f"), busy share {t['device_busy_share_of_timed_step']:.3f}, loss "
              f"{t['loss_first']:.5f} -> {t['loss_last']:.5f}; flash launches by body "
              + json.dumps(t["launches_by_body"]))
    for cell in ("bert-cls", "bert-cls bf16", "bert-mlm", "seq2seq"):
        h = heads[cell]
        print(f"{card}: {cell} ({h['num_layers']} x {h['hidden_size']}, vocab {h['vocab_size']}, "
              f"seq {h['seq_length']}" + (f", source {h['source_length']}" if h["source_length"]
                                          else "") + f", batch {h['batch']}, dropout 0.1): "
              f"{h['samples_per_s']:.2f} samples/s, step {h['step_ms']:.3f} ms, device ms a step "
              f"{h['step_device_ms']:.3f} (" + ", ".join(
                  f"{g} {ms:.3f}" for g, ms in h["step_device_ms_by_group"].items())
              + f"), dropout masks {h['dropout_mask_ms_per_step_cuda_events']:.3f} ms a step "
              f"(CUDA events), loss without dropout {h['loss_without_dropout'][0]:.5f} -> "
              f"{h['loss_without_dropout'][1]:.5f}; flash launches by attention kind "
              + json.dumps(h["flash_launches_by_attention_kind"]))
    for t in (trainer["fp32"], trainer["bf16"]):
        r = t["runs"]
        print(f"{card}: trainer, BERT-Base {t['dtype']} (12 x 768, seq 128, batch 32): step ms "
              + "; ".join(f"{k} " + ", ".join(f"{x['ms']:.3f}" for x in r[k]) for k in r)
              + "; peak GB " + "; ".join(f"{k} " + ", ".join(f"{x['peak_bytes'] / 1e9:.3f}"
                                                        for x in r[k]) for k in r)
              + f"; remat bitwise {t['gates']['remat']['bitwise_equal']}, accumulation param "
              f"diff {t['gates']['accum']['param_max_abs_diff']:.3e} of update "
              f"{t['gates']['accum']['param_max_update']:.3e}; DataLoader ms a step "
              + ", ".join(f"{x['ms_per_step']:.3f}" for x in t["dataloader"]["loader"])
              + " vs staged " + ", ".join(f"{x['ms_per_step']:.3f}" for x in t["dataloader"]["staged"])
              + f", busy share {t['dataloader']['loader_profiled']['device_busy_share']:.3f} vs "
              f"{t['dataloader']['staged_profiled']['device_busy_share']:.3f}")
    ck = trainer["checkpoint"]
    print(f"{card}: checkpoint and resume, bert-cls fp32: {ck['checkpoint_bytes']} bytes a "
          f"checkpoint, save s " + ", ".join(f"{x:.3f}" for x in ck["save_s"])
          + f", resuming process {ck['child_s']:.1f} s, resumed losses bit for bit "
          f"{ck['resumed_losses']}, torn newest fell back to step {ck['fallback_step']}")
    v = vision
    print(f"{card}: ResNet-50 (224 x 224, 1000 classes, batch 32, fp32, TF32 off): "
          f"{v['images_per_s']:.2f} images/s, step {v['step_ms']:.3f} ms, device ms a step "
          f"{v['step_device_ms']:.3f} (" + ", ".join(
              f"{g} {ms:.3f}" for g, ms in v["step_device_ms_by_group"].items())
          + f"), busy share {v['device_busy_share_of_timed_step']:.3f}, peak "
          f"{v['peak_mem_gb']:.3f} GB, loss {v['loss_first']:.5f} -> {v['loss_last']:.5f}; "
          f"card vs CPU loss {v['card_vs_cpu']['loss_card']:.6f} vs "
          f"{v['card_vs_cpu']['loss_cpu']:.6f}; remat step ms "
          + ", ".join(f"{x['ms']:.3f}" for x in v["remat"]["runs"]["remat"]) + " vs "
          + ", ".join(f"{x['ms']:.3f}" for x in v["remat"]["runs"]["plain"]) + ", peak GB "
          + ", ".join(f"{x['peak_bytes'] / 1e9:.3f}" for x in v["remat"]["runs"]["remat"])
          + " vs " + ", ".join(f"{x['peak_bytes'] / 1e9:.3f}" for x in v["remat"]["runs"]["plain"])
          + "; forward ms at batch 8 " + ", ".join(
              f"{k} {f['forward_ms']:.2f}" for k, f in v["forward_other"].items()))
    print_window(card, window)
    print_moe_keras(card, moe, keras_, vision["forward_profile"])
    print_frontends(card, onnx_, fx_)
    print_search(card, search)
    print_programs(card, programs)
    inf = heads["infer"]
    print(f"{card}: bert_sst2 over /v2/models/bert_sst2/infer ({inf['clients']} clients, "
          f"{inf['requests']} requests of 1-4 rows): {inf['requests_per_s']:.2f} requests/s, "
          f"{inf['rows_per_s']:.2f} rows/s, client latency p50 {inf['latency_p50_s']:.4f} s, "
          f"p99 {inf['latency_p99_s']:.4f} s, {inf['requests_per_device_batch']:.2f} requests a "
          f"device batch over {inf['device_batches']}; load {inf['load_s']:.2f} s")
    for label in ("train", "causal512"):
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            for form in ("", "_bf16", "_f16"):
                r = flash[label][name + form]
                print(f"{card}: flash {label} {name + form} ({r['body']} body): {r['ms']:.4f} ms "
                      f"(bound {r['bound_ms']:.4f} by {r['bound_by']}, plain {r['plain_ms']:.4f}, "
                      f"SDPA {r['library_ms']:.4f})")
    for label, run in (("graph", "graph"), ("eager", "eager")):
        print(f"{card}: 4-slot serving, {label} steps, overlap on: decode call ms "
              "(dispatch + consume wait, not a step time) "
              + ", ".join(f"{r['decode_call_ms']:.3f}" for r in serving[run])
              + "; TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in serving[run])
              + "; tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in serving[run]))
        print(f"{card}: 1-slot long context, {label} steps: decode call ms "
              + ", ".join(f"{r['decode_call_ms']:.3f}" for r in long_ctx[run]))
        sp = speculation[run]
        print(f"{card}: speculation k=4, {label} steps: verify step ms {sp['verify_step_ms']:.3f}, "
              f"acceptance {sp['acceptance_rate']:.4f}, tokens per verify step "
              f"{sp['tokens_per_verify_step']:.3f}, tokens/s {sp['tokens_per_s']:.1f}")
        for on in ("on", "off"):
            rs_ = prefix["runs"][f"prefix {on}, {label} steps"]
            print(f"{card}: shared 512-token system prompt, prefix cache {on}, {label} steps: "
                  "TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in rs_)
                  + "; prefill step ms per request "
                  + ", ".join(f"{r['prefill_ms_per_request']:.3f}" for r in rs_)
                  + "; tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in rs_)
                  + ("; suffix prefill ms by bucket " + "; ".join(
                      ", ".join(f"W={w} {ms:.3f}" for w, ms in r["suffix_prefill_ms_by_bucket"]
                                .items()) for r in rs_) if on == "on" else ""))
    for mode in ("on", "off"):
        rs_ = overlap["runs"][mode]
        print(f"{card}: 4-slot serving, graph steps, overlap {mode}: "
              "tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in rs_)
              + "; TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in rs_))
        for name in ("graph", "eager"):
            st = overlap[f"steady_{name}"][mode]
            print(f"{card}: steady 4-slot decode, {name} steps, overlap {mode}: ms per step "
                  + ", ".join(f"{r['ms_per_step']:.3f}" for r in st)
                  + "; dispatch / execute / readback ms per step " + ", ".join(
                      f"{r['dispatch_ms_per_step']:.3f} / {r['execute_ms_per_step']:.3f} / "
                      f"{r['readback_ms_per_step']:.3f}" for r in st)
                  + "; stream ms per step " + ", ".join(f"{r['stream_ms_per_step']:.3f}" for r in st)
                  + "; device ms per step " + ", ".join(f"{r['device_ms_per_step']:.3f}" for r in st)
                  + "; device busy share " + ", ".join(f"{r['device_busy_share']:.3f}" for r in st)
                  + "; SM clock, power " + ", ".join(r["clocks_sm_power"] for r in st))
    cruns = constrained["runs"]
    print(f"{card}: constrained decoding: grammar compile s "
          + ", ".join(f"{t:.3f}" for t in constrained["compile_s"])
          + f"; masked slot-steps {constrained['masked_steps']}; verify step ms (k=4, "
          f"constrained slots) {cruns['graph, speculation k=4']['verify_step_ms']:.3f}")
    for label, rs_ in constrained["stretch"].items():
        print(f"{card}: 4-slot decode, graph steps, {label}: ms per step "
              + ", ".join(f"{r['ms_per_step']:.3f}" for r in rs_)
              + "; dispatch / execute / readback ms per step " + ", ".join(
                  f"{r['dispatch_ms_per_step']:.3f} / {r['execute_ms_per_step']:.3f} / "
                  f"{r['readback_ms_per_step']:.3f}" for r in rs_) + "; mask bytes per step "
              + ", ".join(f"{r['mask_bytes_per_step']:.0f}" for r in rs_))
    for name in ("cold", "warm"):
        b = server[name]
        print(f"{card}: HTTP front end, 4-slot serving cell (4 SSE + 4 JSON), {name}: TTFT p50 s "
              f"{b['http_ttft_p50_s']:.4f} (client clock, SSE) vs {b['trace_ttft_p50_s']:.4f} "
              f"(scheduler trace); tokens/s {b['tokens_per_s']:.1f} (HTTP) vs "
              f"{server['direct_tokens_per_s']:.1f} (scheduler direct); before submit ms p50 "
              f"{b['pre_submit_ms_p50']:.2f}, max {b['pre_submit_ms_max']:.2f}; SSE delivery ms "
              f"p50 {b['sse_delivery_ms_p50']:.3f}; front end ms per token "
              f"{b['front_end_ms_per_token']:.4f}")
    st = durable["steady"]

    def per_step(rs_, key="ms_per_step", fmt="{:.3f}"):
        return ", ".join(fmt.format(r[key]) for r in rs_)

    print(f"{card}: durable serving, steady 4-slot decode (graph steps, overlap on, 128 steps; "
          f"rounds in turns): ms per step durability off {per_step(st['durable_off'])}; on with "
          f"fsync {per_step(st['durable_fsync'])}; on without fsync "
          f"{per_step(st['durable_no_fsync'])}; device busy share off / fsync / no fsync "
          + " / ".join(per_step(st[f"durable_{m}"], "device_busy_share")
                       for m in ("off", "fsync", "no_fsync")))
    for m in ("fsync", "no_fsync"):
        print(f"{card}: durable serving, {m.replace('_', ' ')}: flush_step host ms p50 "
              f"{per_step(st[f'durable_{m}'], 'flush_step_ms_p50', '{:.4f}')}, p99 "
              f"{per_step(st[f'durable_{m}'], 'flush_step_ms_p99', '{:.4f}')}, its WAL write's max "
              f"{per_step(st[f'durable_{m}'], 'wal_write_ms_max', '{:.4f}')}; fsyncs per s "
              f"{per_step(st[f'durable_{m}'], 'fsyncs_per_s', '{:.1f}')}; WAL bytes per token "
              f"{per_step(st[f'durable_{m}'], 'wal_bytes_per_token', '{:.1f}')}")
    print(f"{card}: warm restart after SIGKILL (GPT-2 small, 4 slots, 257 fp32 blocks): scan s "
          f"{durable['scan_s']:.4f} ({durable['scan_records']} records), warm_restart() s "
          f"{durable['warm_restart_s']:.4f}, replayed {durable['replayed_streams']} streams / "
          f"{durable['replayed_tokens']} tokens, torn records {durable['torn_records']}; TTFT of "
          "the resumed streams s " + ", ".join(f"{t:.4f}" for t in durable["resumed_ttft_s"])
          + f"; journaled tokens at the kill {durable['journaled_tokens_at_kill']}")
    print(f"{card}: steady 4-slot decode, journeys on: ms per step {per_step(st['journeys_on'])}; "
          f"journeys off: {per_step(st['journeys_off'])}")
    for name in ("single", "fleet", "disagg"):
        f = fleet[name]
        print(f"{card}: fleet phase, serving cell, "
              + {"single": "single engine", "fleet": "Fleet of 2 replicas",
                 "disagg": "DisaggregatedFleet 1 prefill + 1 decode"}[name]
              + f" (threaded loops): tokens/s {f['tokens_per_s']:.1f}, TTFT p50 s "
              f"{f['ttft_p50_s']:.4f}, max {f['ttft_max_s']:.4f}; steady decode ms per step "
              + ", ".join(f"{ms:.3f}" for ms in f["steady"]["ms_per_step"])
              + f" ({f['steady']['tokens_per_s']:.1f} tokens/s over "
              f"{4 * len(f['steady']['ms_per_step'])} streams)")
    d = fleet["disagg"]
    print(f"{card}: KV handoff, serving cell: {d['payload_bytes']} payload bytes; pack ms p50 "
          f"{d['pack_ms_p50']:.3f}, max {d['pack_ms_max']:.3f}; import ms p50 "
          f"{d['import_ms_p50']:.3f}, max {d['import_ms_max']:.3f} (host ms of the calls)")
    fo = fleet["failover"]
    print(f"{card}: fleet failover: replacement spawn and capture "
          f"{fo['replacement_spawn_capture_s']:.2f} s while the survivor took "
          f"{sum(fo['survivor_decode_steps_during_spawn'].values())} decode steps; counters "
          + json.dumps(fo["fleet"]))
    kv = kv_dtype
    print(f"{card}: kv cache bf16 ({kv['cache_bytes']} bytes against fp32's "
          f"{kv['fp32_cache_bytes']}), 4-slot serving cell: tokens/s "
          + ", ".join(f"{kv['runs'][m]['tokens_per_s']:.1f} ({m})" for m in ("graph", "eager"))
          + f"; decode step device ms fp32 {kv['decode_step_device_ms']['fp32']} bf16 "
          f"{kv['decode_step_device_ms']['bf16']}; tokens equal to the fp32 cache's "
          f"{kv['tokens_equal_to_fp32_cache']} of {kv['tokens']}; host tier {kv['host_tier']}")
    for name, r in rows.items():
        if name in {f"{case}{form}" for case in ("decode", "append_w5", "split")
                    for form in ("_bf16", "_f16")}:
            print(f"{card}: paged kernel {name} ms {r['ms']:.5f} (bound {r['bound_ms']:.5f} "
                  f"by {r['bound_by']}, plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f})")
    for name, r in rows.items():
        if name.startswith(("wide", "verify_w4", "split_w64")):
            print(f"{card}: paged kernel {name} ({r['body']}) ms {r['ms']:.4f} (bound "
                  f"{r['bound_ms']:.5f} by {r['bound_by']}; CUDA-core bound "
                  f"{r['cuda_core_bound_ms']:.5f}, tensor-core bound "
                  f"{r['tensor_core_bound_ms']:.5f}; plain {r['plain_ms']:.4f}, SDPA "
                  f"{r['library_ms']:.4f})")
    # the paged forms' launches by window in the runs that count them: the
    # prefix phase (fp32), the kv-dtype phase (2-byte forms) and the
    # profiled suffix prefills (every form)
    by_window = {}
    for counts in ([r["launches_by_window"] for rs_ in prefix["runs"].values() for r in rs_]
                   + [kv_dtype["launches_by_window"]]
                   + [s["launches_by_window"] for s in suffix_bodies.values()]):
        for k, n in counts.items():
            by_window[k] = by_window.get(k, 0) + n
    print(f"{card}: paged launches by window (prefix, kv-dtype and suffix-body runs): "
          + json.dumps({k: n for k, n in by_window.items() if n}))
    for ctype, s in suffix_bodies.items():
        print(f"{card}: W=1024 suffix prefill over a {ctype} cache: device ms "
              f"{s['suffix_prefill_device_ms']:.3f}, paged kernels {s['device_kernels']}")
    print(json.dumps({"card": card, "serving": serving, "kv_dtype": kv_dtype,
                      "long_context": long_ctx,
                      "step_graphs": graphs, "speculation": speculation, "prefix": prefix,
                      "overlap": overlap, "constrained": constrained, "server": server,
                      "durable": durable, "fleet": fleet, "tools": tools,
                      "anatomy": anatomy, "kernel_shapes": rows, "flash_shapes": flash,
                      "training": training, "training_bf16": training_bf16,
                      "training_f16": training_f16, "heads": heads,
                      "suffix_prefill_bodies": suffix_bodies, "trainer": trainer,
                      "vision": vision, "window": window, "moe": moe, "keras": keras_,
                      "onnx": onnx_, "fx": fx_, "search": search, "programs": programs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
