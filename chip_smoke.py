#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — compile every kernel under paddle_tpu_torch/csrc with nvcc
             (one process per source, all started together); registers
             and spill stores of every flash forward, backward, dense and
             paged decode and fused LN instantiation (the LN backward must
             not spill), the bf16 forward's largest SASS
             basic blocks (a tile's softmax) counted by opcode class, and
             the f32 forward's SASS at each D (32, 64, 128, 256): its
             TF32 HMMAs must
             outnumber its FFMAs (the products on the tensor cores); the
             f32 backward's kernels at D = 32 and 64: each must run
             TF32 HMMAs (FFMAs beside) and spill nothing; and
             #11's f32 kernel at each tile width: its TF32 HGMMAs, in
             m16n8k8 units a warp, must outnumber its FFMAs;
2. flash   — the flash-attention forward kernel vs its plain PyTorch twin
             at gpt3-345M prefill shapes (B=1, H=16, D=64, S in 64..1024,
             causal, kv_lens < S; f32 and bf16), plus D=128, sq != sk,
             kv_lens=0, f32 (3xTF32) at D=64, 128 and 256 with dropout 0
             and 0.1 (kv_lens 0, mid-tile, sk), and bf16 at D=256 and with
             one query row; a second forward must repeat o and lse bit for
             bit in every case; the f32 kernel's zeros at D=256 with V the
             identity must be the twin's keep mask; times kernel, plain
             twin and torch SDPA, with the f32 bound in 3xTF32;
3. decode  — the paged decode kernel vs its plain twin (paged_attention_ref)
             at serving shapes (B in {8, 32}, Hkv=16, G=1, ps=16, MP=64;
             f32, bf16, int8 pools), plus G=4, a batch with lens 0 and
             lens on a page boundary, the split's edges (lens on a chunk
             boundary and one key either side, one full slot among empty
             ones, one slot), D=128 and 256 in every pool with G=1 and
             G=6, and ps=7; a second call must repeat the first bit for
             bit in every case; at the serving shape one call puts exactly
             one kernel on the device (a captured CUDA graph's nodes, and
             the profiler shows no other) and raises nothing under
             torch.cuda's sync debug mode "error";
4. slice   — gpt3-345M at full width with seeded random weights, f32 on
             cuda, serving 16 greedy requests (prompts 64..512, 64 new
             tokens) through ServingEngine(max_slots=8, page_size=16,
             max_seq_len=1024); both kernels' launch counters must be > 0
             and the free list must come back whole; 2 requests are served
             again on the CPU and must agree (prefill last-row logits
             within 1e-3, first token equal);
5. flash-train — the flash forward (with dropout) and the two backward
             kernels (dq; dk/dv) vs their plain twins at gpt3-345M training
             shapes (B=8, H=16, D=64, S=1024, causal; f32 and bf16; dropout
             0 and 0.1), plus kv_lens < S, kv_lens = 0, sq != sk, D=128 and
             D=256, and GPT-1.3B's shape (B=4, H=16, S=1024, D=128; bf16,
             dropout 0.1) timed; then 27 bf16 cases with dropout 0.1 that
             cut the bf16 kernels' tiles raggedly (D 64/128/256; sq, sk in {1, 63, 65,
             127, 129, 1000}, sq != sk under causal both ways; kv_lens 0,
             mid-tile and sk); a second backward must repeat the first bit
             for bit in every case, a second forward in every bf16 case; with V the identity the forward's
             dropped entries must be exactly the twin's keep mask; times
             kernels, twins and torch SDPA (forward, and its backward for
             dq and dk/dv), with achieved TFLOP/s and share of the bound;
6. adamw   — the one-pass AdamW kernel (lr, bc1 and bc2 read from a
             3-value array on the card) on one leaf vs its plain twin
             on a 1024x4096 leaf and the 50304x1024 embedding, coupled and
             decoupled decay, GPT-1.3B's 50304x2048 embedding and
             2048x8192 MLP leaf, plus an odd length and an unaligned view;
             times kernel, twin and torch.optim.AdamW(fused=True); times
             the launch floor (an add_ on one f32 value, held); then the
             multi-leaf launch over GPT-345M's 388 and DETR-R50's 422 leaf
             shapes, each as is and with biases and norm weights kept from
             decay under a clip scale, over an edge set (a 1-value leaf,
             ragged float4 tails, views off a 16-byte boundary, coupled and
             decoupled) and over 1100 leaves (three launches): each
             against the multi-leaf twin at 1e-6 of max(1, |twin|), a
             second launch bit for bit; the two sets timed (held) beside
             the bound (28 bytes a value), torch.optim.AdamW(fused=True),
             the route with the clip's coefficient, and (unheld) the twin
             and the parent's route (its clip's scaled copies, then #10 a
             leaf of at least 16384 values, alone, and the plain update on
             the rest);
7. train   — gpt3-345M at full width and depth, f32 params on cuda,
             dropout 0, through Engine(GPTPretrainingCriterion,
             AdamW(1e-4, weight_decay=0.01, fused_kernel=True), bf16 AMP):
             batch 8 x 1024 tokens from numpy seed 0, 3 warm-up steps and
             10 timed steps with one sync at the end; per step 24 launches
             of each flash kernel and one multi-leaf AdamW launch over all
             388 f32 leaves (none on the plain path); the loss must be
             finite and fall; one step under torch.profiler for the busy
             share, the host's launches and device time by kind;
8. train-cpu — the same width cut to 2 layers, batch 1 x 256, f32 without
             AMP: one train_batch on cuda and on the CPU from the same
             weights (loss within 1e-4 relative; every gradient leaf within
             1e-3 of its max-abs, the key bias, zero in exact arithmetic,
             within 1e-3 of the largest gradient; params after the step
             within 1e-5 where |grad| >= 1e-6 on both devices, within
             2 * lr where Adam's first step is a step function of a grad
             near eps), then 2 steps on cuda with attention dropout 0.1,
             which must launch every flash kernel with dropout;
9. fused-ln — the fused residual-add + LayerNorm kernels #6-#9 vs their
             plain twins, forward outputs and every gradient: f32 and bf16
             rows, H in {64, 768, 1024}, N in {7, 8192, 16384}, and H in
             {100, 1000} at N in {7, 8192} and {7, 16384}, the wide rows
             H in {1025, 1536, 2048, 2056, 3000, 4096, 8192} at N in
             {7, 4096}, eps 1e-12 and 1e-5, gamma/beta in f32 and in the
             rows' dtype, and rows that start one value into a buffer, off
             a 16-byte boundary (H 1023, 101, 2048 and 3000); a second
             backward must repeat bit for bit and a row wider than MAX_H
             must raise naming ROADMAP queue 2; the backward's row kernel
             must reside as many blocks an SM as its plan's grid counts on
             (cudaOccupancyMaxActiveBlocksPerMultiprocessor; exactly as
             many for a wide row), with no local bytes; times at ERNIE's
             (N=16384, H=768), GPT's (N=8192, H=1024) and GPT-1.3B's
             (N=4096, H=2048) shapes in bf16, beside
             aten.native_layer_norm_backward and the eager
             F.layer_norm(x + r) pair;
10. flash-noncausal — the three flash kernels with causal=False at ERNIE's
             shape (B=32, H=12, S=512, D=64; bf16 and f32; no kv_lens and
             kv_lens < S), bf16 timed next to SDPA(is_causal=False); f32
             at D=64, 128 and 256 with dropout 0 and 0.1 (kv_lens 0,
             mid-tile, sk);
11. ernie  — ERNIE-3.0-base (ernie-3.0-base-zh: vocab 40000, hidden 768,
             12 layers, 12 heads, task-type embedding) at full width and
             depth, fused_ln, dropout 0, f32 params on cuda, through
             Engine(ErniePretrainingCriterion, AdamW(1e-4,
             weight_decay=0.01, fused_kernel=True), bf16 AMP): bench.py's
             ernie batch, 32 x 512 from numpy seed 0 (15 % of positions
             labelled, random NSP labels), 3 warm-up and 10 timed steps
             with one sync at the end; per step 24 launches each of the
             y-only fused LN forward and backward, 12 of each flash
             kernel and one multi-leaf AdamW launch over all 207 leaves,
             and a falling loss; one step profiled; #10 timed over the
             leaf set;
12. gpt-fused-ln — gpt3-345M training with fused_ln=True at batch 8 x 1024
             (bf16 AMP), 3 steps: 24 launches each of kernels #6 and #7 a
             step and a finite, falling loss;
13. ernie-cpu — ERNIE cut to 2 layers at hidden 768, fused_ln, f32,
             batch 1 x 256: one step on cuda and on the CPU from the same
             weights, held to phase 8's bars;
14. dense-decode — kernel #2 (dense single-query flash_decode) vs its
             plain twin at the generate slice's shapes: GPT's (B=8, H=16,
             D=64) and Llama-2-7B's (B=4, H=32, D=128) over a 576-key
             cache, f32 and bf16, key lengths 1, S, not a multiple of 128
             and 0, plus D=256, a 5-key cache and a 4096-key cache at
             B=1 and 2, H=32 (16 and 8 chunks a row, combined in the
             launch); a second call must repeat the first bit for bit,
             and one call put exactly one kernel on the device (a
             captured CUDA graph's nodes; the profiler shows no other);
             times kernel, twin and torch SDPA over the live keys where
             every row has all 576;
15. generate-gpt — gpt3-345M generate() at full width and depth, f32
             weights from seed 0, batch 8 x 512, 64 new tokens: greedy with
             an f32 and a bf16 cache (24 x 64 launches of kernel #2 each,
             no other kernel), beam search (4 beams, batch 2, eos) and
             sampling (top_k=50, top_p=0.9, repetition_penalty=1.2, eos):
             tokens in range, only pad after eos; tokens/s and ms a decode
             step; 8 decode steps profiled (busy share, kernel #2's share);
16. generate-llama — llama2-7b (32 layers, 32 heads, D=128, FFN 11008)
             with bf16 weights drawn on the card from seed 0, bf16 cache,
             batch 4 x 512, 64 new tokens, greedy: 32 x 64 launches of
             kernel #2, peak memory, tokens/s, ms a step, a profile;
17. generate-gqa — llama-1b (GQA 16:4) at full width, bf16, batch
             4 x 256, 32 new tokens: the grouped plain path, kernel #2 never
             launched;
18. generate-cpu — gpt3-345M and llama2-7b cut to 2 layers at full width,
             f32, the same weights on cuda and on the CPU: prefill logits
             within 1e-3 and 8 greedy tokens equal (prompts 2 x 32);
19. conv-bn-act — kernel #11 (fused 1x1 conv + BatchNorm + ReLU
             (+ residual)) vs its plain twin at the 12 shapes of one
             ResNet-50 forward (batch 256, 224 px) in bf16, four of them
             in f32, residual and ReLU on and off, ragged M (1, 7, not a
             multiple of 128), Cin (3, 100) and Cout (1, 9, 70), and x
             one value off a 16-byte boundary; times the bf16 shapes next
             to their bounds, the twin and the cuBLAS product alone (which
             computes less than #11; no single PyTorch call computes #11's
             function), and the sum over the 32 launches of a forward;
20. resnet-serve — resnet50(layout="NHWC", fused_bottleneck=True) at full
             depth and width, weights from seed 0 on the card, eval, cast
             to bf16 with its running statistics (bench.py's
             _resnet_serve): batch 256 x 3 x 224 x 224 from numpy seed 0
             under inference_mode, 3 warm-up and 10 timed forwards with one
             sync; exactly 32 launches of #11 a forward and no other
             kernel of the port; images/s, ms a forward, peak memory, one
             forward profiled; then bench.py's --fold-bn: the same
             model folded in f32 by incubate.fuse_conv_bn (53 pairs),
             then bf16: no launch of #11 (a folded convolution carries a
             bias), images/s beside the fused route's; then f32 at batch
             64 with random BatchNorm statistics, fused NHWC vs the
             unfused NHWC model: logits within 1e-3 of their max-abs,
             top-1 equal, and the unfused model folded vs itself within
             1e-4;
21. resnet-cpu — resnet50 fused NHWC, f32, batch 2 x 3 x 64 x 64, the same
             weights on cuda (kernel #11) and on the CPU (its twin): logits
             within 1e-3 of their max-abs, argmax equal;
22. gpt-1.3b — gpt3-1.3B (vocab 50304, hidden 2048, 24 layers, 16 heads of
             128) at full width and depth, seeded random weights, dropout
             0, f32 params, bf16 AMP, AdamW(1e-4, weight_decay=0.01,
             fused_kernel=True) through Engine, batch 4 x 1024 (bench.py's
             gpt-1.3b stage without the TPU's recompute and bf16 moments):
             fused_ln off, 2 warm-up and 10 timed steps ending in one
             sync, and on, 2 + 5; per step 24 launches of each flash
             kernel, one multi-leaf AdamW launch over all 388 leaves, 24
             of #6 and #7 with fused_ln (0 without) and none of #8/#9; a
             finite, falling loss; ms a step, tokens/s, peak memory and one
             profiled step each; then #10 timed over the leaf set;
23. gpt-1.3b-cpu — gpt3-1.3B cut to 2 layers at hidden 2048, fused_ln,
             f32, batch 1 x 128: one step on cuda (kernels #6/#7 on rows of
             2048) and on the CPU from the same weights, held to phase 8's
             bars;
24. resnet-train — bench.py's resnet50 stage: resnet50(num_classes=1000,
             layout="NHWC", fused_bottleneck=True), weights from seed 0,
             train mode, Momentum(0.1, momentum=0.9), Engine(model,
             CrossEntropyLoss(), opt, amp_dtype="bfloat16"), batch 256 x 3
             x 224 x 224 and labels from numpy seed 0: 3 warm-up and 10
             timed steps ending in one sync, exactly 17 launches of #11 a
             step (the train-mode route fuses where Cin <= Cout: layer1.0's
             conv1 and the sixteen conv3s, with batch statistics by the
             Gram trick) and no other kernel of the port; a finite loss,
             f32 running statistics that moved, f32 parameters; images/s,
             ms a step, peak memory; one step profiled (busy share, the
             host's kernel launches, device time grouped: cuDNN
             convolutions, elementwise and reduction passes, #11, GEMMs,
             Momentum, the loss); then the same unfused (2 + 5 steps, #11
             never launched) and fused with s2d_stem (3 + 2), each with its
             images/s, ms a step, peak memory and a profiled step;
25. resnet-train-cpu — resnet50 fused NHWC, f32, Momentum(0.1, 0.9), batch
             32 x 3 x 96 x 96, the same weights (BatchNorm statistics and
             affine parameters drawn at random) training 3 steps on cuda
             (#11, 17 launches a step) and on the CPU (its twin), each step
             from the CPU's state: the loss within 1e-4 relative, the
             running statistics within 1e-4 of their max-abs, the
             classifier's velocity within 1e-3 of its max-abs and its
             parameters within 1e-5; every other leaf's update within 5e-2
             relative L2 (an input of a ReLU within the f32 forward's error
             of 0 takes the other side of the kink on the other device,
             and every gradient upstream of it moves), with the share of
             its velocities within 1e-3 of their max-abs reported; both
             devices' first gradients against a float64 step of the
             unfused model on the CPU, the card's median and worst leaf
             at most 1.5x as far from it as the CPU twin's;
26. fit-resnet50 — paddle.Model over io.DataLoader at full width:
             Model(resnet50 NHWC fused, weights from seed 0).prepare(
             Momentum(0.1, 0.9), CrossEntropyLoss(), Accuracy(topk=(1, 5)),
             amp_configs="O1"), fit(SyntheticImageNet(224 px), batch_size
             256, 1 epoch of 13 steps, shuffle, drop_last, num_workers=2)
             with a callback that stamps every step end (steps 4-13 timed,
             step 3 profiled: busy share, memcpy, launches): exactly 17
             launches of #11 a step and no other kernel of the port,
             finite losses, running statistics that moved; images/s
             beside phase resnet-train's Engine-direct figure, the
             loader's wait a batch, peak memory; then evaluate and
             predict over 512 held-out images (exactly 32 launches of #11
             a forward, f32), save, load into a fresh Model (other seed)
             whose evaluate must equal the first bit for bit; evaluate's
             images/s (both calls) and one f32 forward at batch 256
             profiled (device time, #11's share); #11 in f32 held to its
             twin and timed at the forward's 12 shapes beside its bound
             (3xTF32; the CUDA cores' beside it) and cuBLAS's f32 GEMM
             alone;
27. fit-lenet — the reference's smoke test through Model: LeNet,
             MNIST(mode="train") (6000 synthetic images), Adam(1e-3,
             fused_kernel=True), CrossEntropyLoss, Accuracy, 6 epochs at
             batch 256: exactly 144 launches of #10 (one a step, over
             all 10 leaves) and no other kernel; evaluate(MNIST(mode=
             "test")) acc > 0.95; #10 over that leaf set held to its
             twin and timed; then 3 Model.train_batch calls on cuda and
             on the CPU from the same weights (each from the CPU's
             state), held to phase 8's bars;
28. flash-d32 — kernel #1's f32 forward at head_dim 32 vs its plain twin
             at DETR's three attention shapes (B=8, H=8, non-causal:
             1050 x 1050, 100 x 100, 100 x 1050), key lengths none, 0
             and mid-tile, dropout 0 and 0.1; a second forward bit for
             bit; against a float64 product at the encoder's shape,
             beside D=64, within 1e-4 of max(1, |o|), and D=32 within
             D=64's reading there (4.33e-6); timed at the encoder's shape
             beside SDPA in f32 and the 3xTF32 bound; then #3/#4's f32
             kernels at head_dim 32 (with the forward) vs their twins at
             the same three shapes at detr-train's batch (B=4, H=8), the
             same key lengths and dropouts, a second backward bit for
             bit, timed at each of the three shapes with dropout 0.1 and
             0 beside the twins, SDPA's f32 backward at that dropout and
             the bounds in 3xTF32 and on the CUDA cores; dq, dk and dv
             from a float64 backward of the same inputs at the encoder's
             shape (dropout 0 and 0.1) and GPT's f32 shape (8 x 16 x
             1024, D=64, causal), the twins' beside, within
             F32_BWD_F64_TOL (the CUDA-core kernels' reading there);
29. detr-serve — DETR() at the JAX package's defaults (80 classes, 100
             queries, d_model 256, 8 heads, 6 + 6 layers, feed-forward
             2048, ResNet-50 backbone, NHWC on the card), weights from
             seed 0, eval, f32, batch 8 x 3 x 800 x 1333 (DETR's eval
             resize; 25 x 42 = 1050 encoder tokens) from numpy seed 0
             under inference_mode: exactly 18 launches of #1 a forward
             and no other kernel of the port; finite boxes [8, 100, 4]
             and probabilities [8, 100, 81] summing to 1; images/s and ms
             a forward over 10 forwards ending in one sync, peak memory,
             one forward profiled (busy share, device time grouped:
             cuDNN convolutions, #1, GEMMs, LayerNorm, elementwise);
30. detr-cpu — that model (BatchNorm statistics drawn at random) and a
             CPU copy on one 800 x 1333 image: boxes and probabilities
             within 1e-3 of their max-abs, the top class of every query
             equal;
31. ppyoloe-serve — PP-YOLOE-l (PaddleDetection's ppyoloe_crn_l: CSPResNet
             layers (3, 6, 6, 3), channels (64, 128, 256, 512, 1024), 80
             classes), weights from seed 0 with random BatchNorm
             statistics, eval, f32, batch 8 x 3 x 640 x 640 (8400
             anchors): no kernel of the port (cuDNN convolutions);
             images/s over 10 forwards ending in one sync, peak memory,
             one forward profiled; then folded by incubate.fuse_conv_bn
             (107 pairs): outputs within 1e-4 of the unfolded ones'
             max-abs, images/s; then multiclass_nms (the reference's
             thresholds) on one image's output, timed on the host;
32. ppyoloe-cpu — PP-YOLOE-l with those weights on the card and on the
             CPU, one 640 x 640 image: boxes and scores within 1e-3 of
             their max-abs; the top class of every anchor equal where
             the CPU's top two scores lie further apart than twice the
             devices' largest score difference (random weights put every
             score near 0.5, and the closest top two ~1e-6 apart);
33. detr-train — DETR() at the JAX package's defaults (as detr-serve, with
             dropout 0.1), weights from seed 0, f32, through Model(net,
             inputs=[one]).prepare(AdamW(1e-4, weight_decay=1e-4,
             fused_kernel=True, grad_clip=ClipGradByGlobalNorm(0.1)),
             DETRLoss(80)).fit over io.DataLoader (2 workers): 16 images
             of 800 x 1333 (numpy seed 40) with 1-20 gts each padded to 20
             (cxcywh normalised, w and h in [0.05, 0.5], 80 classes), batch
             4, 4 epochs of 4 steps: per step 18 launches of each of #1,
             #3 and #4 (f32, head_dim 32; #3/#4 6 at each of DETR's three
             attention shapes) and one of #10 over all 422 leaves, no
             other kernel of the port; finite losses, the
             last epoch's below the first's; ms a step and images/s over
             steps 5-16 (and the median step, the loader's wait a batch,
             the host's time between steps), peak memory, the auction's
             host reads and
             iterations a step; one fit step and one Model.train_batch
             profiled (busy share, device time grouped: cuDNN, eager
             passes, GEMMs, #1, #3, #4, #10); the auction alone on one
             batch's cost;
34. detr-train-cpu — a DETR with head_dim 32 (d_model 256, 8 heads) cut to
             2 + 2 layers on the tiny backbone, dropout 0, at 1 x 3 x 256 x
             256: the auction's matches on each device's outputs equal,
             then one step on the card and on the CPU from the same
             weights (BatchNorm statistics drawn at random), AdamW fused
             with the clip, held to phase 8's bars (#1, #3, #4 x 12 on the
             card);
35. ppyoloe-train — PP-YOLOE-l (as ppyoloe-serve), weights from seed 0,
             f32, through Model.fit as detr-train with Momentum(0.00125,
             0.9, L2 5e-4) and PPYOLOECriterion: 32 images of 640 x 640
             (numpy seed 42) with 1-20 gts each as xyxy pixels, batch 8, 4
             epochs of 4 steps: no kernel of the port (cuDNN's
             convolutions, Momentum's foreach kernels); the loss falls; ms
             a step, images/s, peak memory, profiles as detr-train;
36. ppyoloe-train-cpu — a small PP-YOLOE (layers (1, 1, 1, 1), channels
             (16, 32, 64, 128, 256), 80 classes) at 2 x 3 x 160 x 160: the
             task-aligned assignment on each device's outputs equal at
             every anchor clear of a tie (its metric further from its gt's
             k-th metric, and its best two candidates further apart, than
             twice the devices' largest metric difference), then one
             Momentum step on the card and on the CPU, phase 8's bars on
             the loss and the gradients, and each leaf's parameters after
             the step within 1e-5 + lr x 1e-3 x its gradient max-abs (the
             gradient bar carried through a step linear in the gradient).
37. train-graph — each training path's step recorded by the Engine as one
             CUDA graph (its first step eager, its second recorded and
             replayed, every later one replayed) against the eager step
             from the same weights, batch and generator state, 5 steps
             each: gpt3-345M (8 x 1024, bf16 AMP, fused AdamW; dropout 0
             under a linear warm-up that moves lr between the replays,
             then dropout 0.1), ERNIE-3.0-base (32 x 512, fused_ln),
             GPT-1.3B (4 x 1024; eager first, then captured, each alone:
             two would not fit beside the graph's pool) and ResNet-50
             fused (256 x 224, Momentum); losses and parameters bit for
             bit, or within PERF.md §2's bars with the reason logged; the
             recording launches each path's kernels as an eager step does
             (24 of each flash kernel and one #10 a GPT step, #8/#9 24 and
             #11 17 a step) and no plain twin; GPT-345M's graph holds
             exactly 24 of each flash kernel and one #10 (its nodes read
             from the CUDA driver), one replay raises nothing under the
             sync debug mode "error", and train_batch_multi with K = 10
             matches 10 train_batch calls; 4-way accumulation (4 x 2 x
             1024 against one 8 x 1024 step, f32, two windows, the apply
             step's graph holding #10 once) at §2's bars; LeNet through
             Model.fit (2 epochs at batch 256, the tail batch recorded
             apart); for each, eager against captured in turns within the
             call: ms a step, busy share, host launches a step
             (cudaLaunchKernel against cudaGraphLaunch) and peak memory.
             DETR-R50's Engine (phase 33) runs eagerly: its loss declares
             a host read, which the phase logs.
38. zoo-serve — the classification zoo at 1000 classes, weights from seed
             0 with random BatchNorm statistics, eval, f32 NCHW, batch 64:
             vgg16, alexnet, squeezenet1_1, mobilenet_v1, mobilenet_v2,
             mobilenet_v3_large, densenet121, shufflenet_v2_x1_0 and
             googlenet at 224 x 224, inception_v3 at 299 x 299; no kernel
             of the port (cuDNN's convolutions); images/s and ms a forward
             over 10 forwards ending in one sync, peak memory, one forward
             profiled (busy share, device time by kind); each model's
             first 2 images on the card and on the CPU from the same
             weights (logits 1e-3 of their max-abs, top-1 equal away from
             a tie); mobilenet_v2 through Model.evaluate and
             Model.predict over io.DataLoader (512 images), predict equal
             to a direct forward;
39. zoo-train — mobilenet_v2 (scale 1.0, dropout 0.2), weights from seed
             0, f32, batch 256 x 224, through Model.fit with AdamW(1e-3,
             weight_decay=1e-4, fused_kernel=True) for 12 captured steps:
             #10 launched by the eager first step and the recording, once
             each, held once in the step's graph, no plain twin; the loss
             falls; ms a step, images/s, peak memory, a profiled step;
             the eager and the captured Engine from the same weights,
             batch and generator state, 5 steps in lockstep (bit for bit,
             else each parameter within 2 * lr and all but 5e-4 of the
             elements within 1e-5: Adam moves an element whose gradient
             lies within rounding of 0 by +-lr) and timed in turns; one
             step on the card against the CPU at batch 8 x 224 (dropout
             off; the gradients read against a float64 step, as
             resnet-train-cpu reads ResNet-50's; parameters 1e-5 where
             the devices' gradients agree in sign, else 2 * lr); #10 at
             MobileNetV2's 158 leaves against its twin, timed beside its
             bound and torch.optim.AdamW(fused=True);
40. vision-ops — each op of vision.ops on the card against the CPU at a
             detector's sizes: nms over 2000 boxes of 80 categories with
             and without top_k (indices equal), roi_align and roi_pool
             over 512 RoIs on [2, 256, 200, 336] at 7 x 7, PSRoIPool on
             [2, 490, 50, 84], deform_conv2d v2 on [2, 256, 100, 168] (3 x
             3, 256 out), box_coder on 2000 priors, yolo_box on [8, 255,
             20, 20], distribute_fpn_proposals of 2000 RoIs (levels
             equal); f32 1e-4 of max(1, |cpu|); ms on the card and the
             synchronizing calls a call;
41. llama-flash — #1, #3 and #4 at llama-1b's training attention shape
             (B=4, H=16, S=1024, D=128, causal, bf16, no dropout), k and
             v drawn with 4 heads and expanded to 16 as the model hands
             them over, vs their twins, timed beside SDPA on the same
             inputs; a ragged GQA case with kv_lens and dropout 0.1;
             runs after phase 28;
42. gpt-1.3b-options — bench.py's gpt-1.3b stage with --recompute
             --fused-qkv --chunked-ce 1024 --scan-layers against the plain
             configuration (phase 22's), both eager and resident, the
             options model from the plain one's weights (layers stacked,
             q/k/v fused by load_numpy_state): first-step losses within
             1e-2 relative, ms a step in turns, a step's peak memory above
             the resident state; the forward twice a layer a step, #10
             over every stacked f32 leaf; runs after phase 23;
43. llama-train — bench.py's llama worker: llama-1b (hidden 2048, 22
             layers, 16 heads of 128 over 4 kv heads, FFN 5632, vocab
             32000) at full width and depth, seeded random weights, batch
             4 x 1024, bf16 AMP, recompute, AdamW(1e-4, weight_decay=0.01,
             moment_dtype="bfloat16") through the Engine: captured, 2
             warm-up + 10 timed steps (tokens/s, ms a step, peak memory,
             a profiled step by kind; #1 44 and #3/#4 22 launches a step,
             counted by the wrappers over the eager and recorded steps
             and as the recording's graph nodes; no #10 launch, the
             rounding twice a leaf a step); eager with recompute on and
             off (peak memory); the eager and the captured Engine from
             the same weights, 3 steps in lockstep held to each other,
             then timed in turns (busy share, host launches a step);
44. llama-train-cpu — llama-1b cut to 2 layers, f32, recompute, bf16
             moments, batch 1 x 128, one step on the card against the CPU
             to phase 8's bars; the bf16-moment update at step 5 over
             llama-1b's q, k, gate, down and norm shapes on the card
             against the CPU from the same numpy noise bits: parameters
             within 1e-6 of max(1, |p|), m and v within one bf16 ulp with
             at most 1e-4 of them not bit for bit;
45. recompute-dropout — gpt3-345M at dropout 0.1, batch 8 x 1024, bf16
             AMP: the eager Engine without recompute against the
             captured one with it, same weights and generator seed, 3
             steps in lockstep (bit for bit or the bars a step), the
             recording launching #1 48 times (twice a layer), #3/#4 24,
             #10 once; runs after phase 42.
46. fp16-guard — #1/#3/#4 in float16 against their twins (GPT's
             training shape and D = 128 timed beside SDPA in float16,
             ragged and kv_lens cases, the keep mask, an overflow case
             whose infs must sit in the twins' places); the float16
             call still to port (#1 at head_dim 32) refusing;
             #10 with the guarded step's finite flag; gpt3-345M float16
             AMP through Model.fit under TrainGuard and a GradScaler (14
             captured steps, a nan_grads storm over steps 6-8, one
             rollback in place, the scale replayed on the host);
             gpt3-345M with fused_ln under the same guard, captured (24
             float16 nodes each of #6 and #7 in its graph); eager against
             captured bit for bit; the eager O2 API; a 2-layer step
             against the CPU holding the loss, the unscaled gradients
             leaf by leaf and their norm; runs after phase 37 (alone:
             --fp16-guard).
47. fp16-kernels — #6-#9 in float16 against their twins within 2
             float16 ulps of max(1, |twin|) (ERNIE's 16384 x 768 and
             GPT's 8192 x 1024 rows, ragged and wide widths, rows off a
             16-byte boundary, gamma/beta float16 and f32; an overflow
             case: x + r past 65504 stored as inf at the twin's places),
             the float16 backward residing as bf16's plan counts on;
             #11 in float16 at the 12 shapes of a ResNet-50 forward and
             ragged ones within 2 float16 ulps of max(1, |twin|), and an
             overflow case; each timed beside its bf16 instantiation and its
             bound (alone: --fp16-kernels).
48. fp16-ernie — ERNIE-3.0-base pretraining (fused_ln, batch 32 x 512,
             AdamW fused) in float16 O1 under TrainGuard and a
             GradScaler(65536, incr_every_n_steps=4), captured: 14 steps
             with a nan_grads storm over steps 6-8 rolled back in place,
             the outcomes and scale replayed on the host; the graph
             holding 24 float16 nodes each of #8 and #9, 12 of each of
             #1/#3/#4 and one #10; eager against captured (bit for bit
             or the training-step bar: the embedding backward adds with
             atomics); a 2-layer step against the CPU, each leaf's
             unscaled gradient within 1e-2 relative L2 (alone:
             --fp16-ernie).
49. fp16-resnet — resnet50 (NHWC, fused_bottleneck, batch 256 x 224)
             trained through Model.fit in float16 O1 with Momentum under
             the same guard but rollback_after=4 (its first three steps
             overflow at scales 65536-16384, RESNET_F16_GUARD), captured:
             a 4-step storm rolled back in place,
             17 float16 nodes of #11 in the graph and no other kernel of
             the port, f32 running statistics that moved and stood
             still on each skipped step; eager against captured; a step
             of a cut ResNet (stem, layer1, layer2) at 16 x 64 x 64 on
             the card against the CPU: the loss, the gradient norm, the
             classifier's gradients and updates at 1e-2, the leaves
             behind a ReLU, where a rounding flips one on one device,
             at RESNET_CUT_LEAF_BAR and RESNET_CUT_RATIO_BAR (alone:
             --fp16-resnet).
50. fp16-decode — #5 in float16 at llama-1b's serving decode shape (B=32,
             Hkv=4, G=4, D=128, pages of 128, 2 a slot): float16 q over
             f32, bf16 and int8 pools and over float16 pools, beside f32
             q over f32 pools, timed (held, L2 flushed) beside the twin
             and the bound; float16 q over each pool at G 1, 4 and 6 (lens
             0, 1, a page edge, the full table) and at D 64 and 256; the
             split at llama-1b's shape one wave for every pool
             (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs);
             #2 with a float16 cache at llama2-7b's (B=4, H=32, D=128)
             and GPT's (B=8, H=16, D=64) decode shapes over 576 keys,
             ragged and full (timed beside SDPA in float16), at D=256 and
             over 4096 keys; each held to its twin within 5e-3 of max(1,
             |twin|) and repeated bit for bit; runs after phase 14;
51. generate-fp16 — llama2-7b generate() with float16 weights drawn on the
             card from seed 0 and a float16 cache, batch 4 x 512, 64 new
             tokens, greedy: 32 x 64 launches of #2 in float16, no other
             kernel of the port and no twin; first tokens equal to an f32
             cache's; tokens/s, ms a step, peak memory, 8 steps profiled;
             runs after phase 16 (alone with phase 50: --fp16-decode);
52. llama-serve — bench.py --serve --serve-model llama off smoke on the
             port: llama-1b (vocab 32000, hidden 2048, 22 layers, 16 heads
             of 128 over 4 kv heads, FFN 5632) at full width and depth, f32
             weights from seed 0, ServingEngine(page_size=128,
             max_seq_len=256, steps_per_dispatch=16) at batch 1, 8 and 32
             over f32, bf16 and int8 caches: prompts 96/120/64/100 from
             numpy seed 0, 128 new tokens, a warm-up wave of batch requests
             (one dispatch), then a timed wave of 2 x batch; #5 22 launches
             a decode step and #1 22 a prefill, no other kernel and no
             twin, every page back; with the f32 cache, requests' greedy
             tokens equal the model's generate() on the card (GREEDY_TIE
             excepted); then the model cast to float16 at batch 32 over
             each cache (#5 with float16 q); decode tokens/s, ms a step,
             TTFT p50, peak memory, a batch-32 dispatch profiled in f32
             and float16;
53. llama-serve-cpu — llama-1b cut to 2 layers at full width, f32, the same
             weights on the card and the CPU: the prefill's last-row
             logits (bucket 128, kv_lens) within 1e-3 and 2 requests' 16
             greedy tokens equal (GREEDY_TIE excepted); runs after phase
             18 (alone with phase 52: --llama-serve).
54. masked-flash — #1, #3 and #4 with a dense mask (their DENSE
             instantiations) against their twins: padding,
             generate_square_subsequent_mask, GPT's causal + left padding
             (NaN rows), a [B, H, Sq, Sk] bias and a bias at the dtype's
             lowest value (rows biased whole), f32 D 32-256, bf16 and
             float16 D 64-256; lse's (hi, lo) pair held; each repeated bit
             for bit; timed at ERNIE's fine-tune shape (bf16, f32) and
             GPT's causal shape (bf16) beside the unmasked kernels, the
             twins and SDPA with the mask (alone: --masked-flash).
55. ernie-finetune — ernie-3.0-base-zh ErnieForSequenceClassification
             through Model.fit at 32 x 128 on padded batches, bf16 O1
             captured, then f32; evaluate and predict; every flash launch
             masked (alone with phase 56: --ernie-finetune).
56. transformer-mask — nn.Transformer(512, 8) with padding and
             subsequent masks, one forward and backward against the CPU.

Tolerances on the card (kernel vs plain twin, same inputs):
  f32  1e-4 — the kernel sums in another order than the dense plain path;
              the f32 forward's products are 3xTF32 (hi.hi + hi.lo +
              lo.hi of operands split into two TF32 parts, ~2^-21
              relative), measured near 1e-6, and so are the f32
              backward's at D = 32 and 64;
  float16 5e-3 — float16 rounds at 11 bits of mantissa: 5e-3 of
              max(1, |twin|), a few ulps of a value in [1, 2) (#1/#3/#4,
              #2 and #5: f32 sums in another order, rounded once); the
              fused LN kernels #6-#9 and #11 to 2 float16 ulps of max(1,
              |twin|);
  bf16 2e-2 — bf16 inputs and outputs round at 8 bits of mantissa; for
              the backward's grads, whose magnitudes pass 1, 2e-2 of
              max(1, |twin|), since one bf16 ulp of a value in [4, 8) is
              3.1e-2;
  conv-bn-act: f32 1e-4 and bf16 2e-2 of max(1, |twin|) — the product
              summed in another order (f32: 3xTF32 on the tensor cores,
              like the f32 flash forward); bf16 y rounds to 8 bits;
  int8 1e-4 — both dequantize value * scale in f32 the same way; only
              the summation order differs;
  AdamW 1e-6 — the same f32 arithmetic, contracted into FMAs on the card;
  fused LN dgamma/dbeta 1e-4 of max(1, |twin|) — f32 sums over N rows
              taken in another order than the twin's; mu 1e-4, rstd 1e-4
              relative (it reaches 1/sqrt(eps) on a flat row).
TF32 is switched off for matmuls and cuDNN so the plain twins and the
model's projections compute in full f32.

Each path's launch counts are set to 0 just before it is driven and read
just after: the serving slice (phase 4), the training slice (phase 7),
the ERNIE slice (phase 11), GPT's fused block (phase 12), each
generate() call (phases 15-17, 51), each serving rung's timed wave
(phase 52), one ResNet-50 serve forward (phase 20),
each GPT-1.3B run (phase 22), each ResNet-50 training run (phase 24),
Model.fit, evaluate and predict (phase 26), LeNet's fit (phase 27),
one DETR forward and one PP-YOLOE forward and their 10 timed
forwards (phases 29 and 31), each detection Model.fit (phases 33 and
35), each captured Engine's steps in phase 37 (a replay launches the
recorded kernels from the graph, past the wrappers: its counts are the
Engine's eager first step and its recording), each zoo forward (phase
38, none), MobileNetV2's Model.fit (phase 39), and the float16 runs of
phases 46, 48 and 49 (each its eager first step and its recording; the
graph's float16 nodes are counted beside). Phases 7-27 and 33 run
their Engines eagerly (capture=False), as before phase 37 existed;
PP-YOLOE-l's Model.fit (phase 35) records its step, the Engine's default.

Timing (time_ms): CUDA events around each of 10 launches, L2 flushed
between them; a spin kernel queued first holds the device until the host
has queued them all, so host time inside a timed call (Python, autograd)
never lands in a window, and the run fails if the spin ends first. Every
timed number of the kernel table is reported held (the value) and unheld
(the same launches on a free device, as the host reaches them).

Prints the kernel table as one JSON line (#1 and #2 a row per dtype a
main path runs; #1, #3, #4, #6 and #7 again at GPT-1.3B's shapes, with
a "shape" key; #10 a row per path's leaf set (train, ernie, gpt-1.3b,
fit-lenet, detr-train) with a "path" key, its launches a step and the
parent's route; #11 again on the training path, with a "path" key and
its 17 launches a forward; #11 on fit-resnet50's training and f32
evaluate/predict forwards, with a "path" key; #1
f32 at DETR's head_dim 32, timed at its encoder's shape, on detr-serve;
#1 f32 at head_dim 32 on detr-train, timed at its encoder's shape, #3
and #4 f32 at each of its three attention shapes with their launches
there, the backward's 3xTF32 bound with its CUDA-core one beside in
"bound_cores_ms"),
#1, #3, #4 and #10 on phase 42's path ("path" gpt-1.3b-options), #1,
#3 and #4 at llama-1b's shape on phase 43's captured run ("path"
llama-train, "launches_recorded" a replay's),
and again on phase 37's captured paths (a "path" key "train-graph ...",
its "launches" the captured Engine's counts, "launches_recorded" a
replay's) and #10 on zoo-train's captured Model.fit of MobileNetV2,
#6-#9 and #11 in float16 on the fp16-guard, fp16-ernie and fp16-resnet
runs ("dtype" float16, the bf16 instantiation's time in "bf16_ms"),
#2 in float16 on generate-fp16 (timed at llama2-7b's shape, GPT's in
"gpt_shape"), #5 at llama-1b's shape on llama-serve, f32 for the f32
model's rungs and float16 q for the float16 model's (each pool's time in
"pools_ms"),
every row with its kernel's float16 status ("float16"),
the card's name and power limit (nvidia-smi),
and as the last line {"ok": true, "device": {...}}. Exits non-zero without
a result when no CUDA device is present or when the package is not beside
this script.

Comparisons, each alone and instead of the phases, the other version's
sources given as files (the parent's from `git show
<parent>:paddle_tpu_torch/csrc/<file>`, or a variant), built with the
package's flags and held to the package's kernel at the dtype's bar, both
timed held in turns (theirs, ours, ours, theirs) beside SDPA held and
unheld:

    python3 chip_smoke.py --compare-fwd SRC...     # flash_attention_fwd.cu
    python3 chip_smoke.py --compare-bwd SRC...     # flash_attention_bwd.cu
    python3 chip_smoke.py --compare-decode SRC...  # flash_decode.cu
    python3 chip_smoke.py --compare-paged SRC...   # paged_flash_decode.cu
    python3 chip_smoke.py --compare-ln SRC...      # fused_ln.cu
    python3 chip_smoke.py --compare-conv SRC...    # conv_bn_act.cu

at GPT's training shape with and without dropout and ERNIE's (the
forward also the f32 serving prefill, GPT's shape in f32 with and without
dropout, f32 at D=128 and DETR's encoder at D=32; the backward as a
dq + dk/dv pair, also in f32 at DETR's three attention shapes at
detr-train's batch with dropout 0.1 and GPT's f32 shape, each side's dq,
dk and dv read from a float64 backward beside, with the bounds), for the
dense decode GPT's f32 and Llama-2-7B's bf16 generate shapes, and for the
paged decode phase 3's timed shapes (each decode mode then times the
package's kernel at other targets of blocks a call; the paged mode also
with L2 evicted by a read, with every lens 0 and beside a torch.sum of as
many bytes), and for the fused LN forwards #6 and #8 and backwards #7
and #9 ERNIE's and GPT's bf16 shapes (the backwards beside
aten.native_layer_norm_backward and a torch.addcmul over as many row
bytes, each source also at grids of 132 x 1..5 blocks, its two kernels
under the profiler, ours with a read flush), and for #11 the 12 shapes
of a ResNet-50 forward at batch 256 x 224 px in f32 and bf16 (beside
cuBLAS's GEMM alone and the bound; the 32- and 17-launch sums). The forward
mode first checks that cvt.rna.tf32.f32 rounds as the kernels' integer
tf32 rounding does and times back-to-back mma.sync TF32 products, the
ceiling the f32 kernel is read against.

    python3 chip_smoke.py --train-graph
    python3 chip_smoke.py --zoo-serve
    python3 chip_smoke.py --zoo-train
    python3 chip_smoke.py --vision-ops
    python3 chip_smoke.py --fp16-guard
    python3 chip_smoke.py --fp16-kernels
    python3 chip_smoke.py --fp16-ernie
    python3 chip_smoke.py --fp16-resnet
    python3 chip_smoke.py --fp16-decode
    python3 chip_smoke.py --llama-serve

phase 37, 38, 39, 40, 46, 47, 48 or 49, phases 50 and 51, or phases 52
and 53 alone (every kernel built first), the results as one JSON line.

    python3 chip_smoke.py --compare-steps TREE...

the training paths' steps (``steps_of``) with each tree's package in
turn, eager and, where its Engine takes ``capture``, captured.

    python3 chip_smoke.py --adamw-geometry

builds #10 (csrc/fused_adamw.cu) at six launch geometries (512 or 16
leaves a launch, 1024 to 16384 values a chunk) and times each on LeNet's
leaf set, a 256 x 2048 and a 1024 x 4096 leaf alone, and DETR-R50's and
GPT-345M's leaf sets, each held to the twin.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s on the
# CUDA cores, the dense bf16 tensor-core FLOP/s a bf16 function could run
# at, and the dense TF32 tensor-core FLOP/s: an f32 product at the f32 bar
# takes three TF32 products (3xTF32), so its least time is 3x its FLOPs at
# this rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3, "int8": 1e-4}
# #11's f32 output from the float64 product of the same operands, of
# max(1, |y|): the f32 bar the CPU tests hold the port to
F32_EXACT_TOL = 1e-5
# #1 f32 at D = 32 (DETR's encoder, 8 x 8 x 1050 x 1050) from float64, of
# max(1, |o|): D = 64's reading at that shape, which D = 32 holds since
# each key tile's P.V is summed apart
F32_D32_F64_TOL = 4.33e-6
# #3/#4 f32 (dq, dk and dv) from a float64 backward of the same inputs, of
# max(1, |g|), at each of BWD_F64_CASES: the largest of the three read
# from the CUDA-core kernels the tensor-core ones replaced, on the same
# inputs (--compare-bwd against the parent's source)
F32_BWD_F64_TOL = {("detr-encoder", 0.0): 1.240e-6,
                   ("detr-encoder", 0.1): 9.785e-7,
                   ("gpt-f32", 0.0): 3.428e-6}
ADAMW_TOL = 1e-6
# #6-#9 and #11 in float16 against their twins: within this many float16
# ulps of max(1, |twin|) (the rounding of the same f32 value computed in
# another order, and once more where a sum is stored and read back)
F16_ULPS = 2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# -- timing -------------------------------------------------------------------

class Timing(float):
    """A held time in ms (the value) with the unheld reading of the same
    launches beside it (``unheld``); see time_ms."""
    unheld = None


_SPIN_CYCLES_PER_MS = []


def _spin_rate(torch):
    """Cycles of torch.cuda._sleep a device ms, measured once."""
    if not _SPIN_CYCLES_PER_MS:
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10 ** 7)
        e.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(1e7 / s.elapsed_time(e))
    return _SPIN_CYCLES_PER_MS[0]


def _windows(torch, fn, iters, flush, spin_ms):
    """(mean ms between the events around each launch, host ms to queue
    them all, whether the last event was still pending when the host was
    done); a spin of ``spin_ms`` is queued first when it is not 0."""
    if spin_ms:
        torch.cuda._sleep(int(spin_ms * _spin_rate(torch)))
    t0 = time.perf_counter()
    evs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    queued_ms = (time.perf_counter() - t0) * 1e3
    pending = not evs[-1][1].query()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters, queued_ms, pending


def time_ms(torch, fn, iters=10, flush=None, held=True):
    """Mean device ms of fn() over iters launches, CUDA events around each
    launch only; ``flush`` (run between launches, untimed) evicts L2.

    The value is held: a spin kernel (torch.cuda._sleep) queued first keeps
    the device busy until the host has queued every launch, flush and
    event, so the device runs them back to back and the host's own time
    in fn (Python, autograd's bookkeeping) never lands inside a window.
    The spin lasts 10 ms plus 3x the host time the same launches took to
    queue unheld; if the last event has already completed when the host is
    done, the spin ended too soon: it is tried once more 4x as long, then
    the function raises. ``.unheld`` is the reading without the spin,
    with the events recorded as the host reaches them. ``held=False``
    returns that reading alone, for a call of more launches than the
    device's launch queue takes (thousands): the host then waits on the
    queue, and no spin can hold the device until it has queued them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    free_ms, queued_ms, _ = _windows(torch, fn, iters, flush, 0)
    if not held:
        out = Timing(free_ms)
        out.unheld = free_ms
        return out
    spin_ms = 10.0 + 3.0 * queued_ms
    for _ in range(2):
        held, _, pending = _windows(torch, fn, iters, flush, spin_ms)
        if pending:
            out = Timing(held)
            out.unheld = free_ms
            return out
        spin_ms *= 4
    raise SmokeFailure(f"time_ms: a {spin_ms / 4:.1f} ms spin ended before "
                       "the host had queued the timed launches")


def unheld(x):
    """The unheld reading of a time_ms value (None for any other number)."""
    return getattr(x, "unheld", None)


def bound(bytes_moved, flops, peak=F32_FLOPS):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_pairs(b, sq, sk, lens, causal=True):
    """(q, k) pairs a causal / key-length mask leaves visible: the work
    this run's data needs."""
    vis = 0
    for bi in range(b):
        kl = sk if lens is None else min(lens[bi], sk)
        for r in range(sq):
            vis += max(0, min(r + sk - sq + 1, kl)) if causal else kl
    return vis


# -- phases -------------------------------------------------------------------

# one ptxas record: the mangled entry name, spill stores, registers
_PTXAS_ENTRY = re.compile(r"entry function '([^']+)'.*?(\d+) bytes spill "
                          r"stores.*?Used (\d+) registers", re.S)
_TEMPLATE_ARG = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16",
                 "6__half": "f16", "Lb0E": "false", "Lb1E": "true"}
_TEMPLATE_TOKEN = r"f|a|13__nv_bfloat16|6__half|Li\d+E|Lb[01]E"


def _kernel_name(mangled):
    """(kernel name, template arguments' mangling) of a mangled entry: the
    <length><identifier> ending in "kernel", its length read off the
    digits before it (an anonymous namespace's name may end in digits)."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n, at = int(mangled[i:run.end()]), run.end()
            name = mangled[at:at + n]
            if (len(name) == n and name.endswith("kernel")
                    and re.fullmatch(r"[A-Za-z_]\w*", name)):
                args = re.match(rf"I((?:{_TEMPLATE_TOKEN})+)E",
                                mangled[at + n:])
                return name, args.group(1) if args else ""
    return mangled, ""


def _instantiations(logtxt):
    """[(kernel<args>, registers, spill bytes)] of a ptxas -v log, the
    template arguments read off the mangled names."""
    out = []
    for m in _PTXAS_ENTRY.finditer(logtxt):
        name, targs = _kernel_name(m.group(1))
        toks = re.findall(_TEMPLATE_TOKEN, targs)
        names = [_TEMPLATE_ARG.get(t, t[2:-1]) for t in toks]
        out.append((f"{name}<{','.join(names)}>", int(m.group(3)),
                    int(m.group(2))))
    return out


# SASS opcode classes of the forward's softmax count
_SASS_CLASSES = (
    ("ex2", ("MUFU",)),
    ("int", ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "IMNMX", "LEA", "SEL",
             "IABS", "PRMT", "I2F", "F2I", "VIMNMX")),
    ("float", ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK")),
    ("pack", ("F2FP",)),
    ("shfl", ("SHFL",)),
)


def _cuobjdump():
    """cuobjdump beside nvcc, or None where the toolkit lacks it."""
    from paddle_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(os.path.realpath(_build._nvcc())),
                        "cuobjdump")
    return tool if os.path.exists(tool) else None


# library path -> its SASS functions: each library is dumped once a
# process (its path holds its sources' hash)
_SASS = {}


def _sass_function(lib, kernel):
    """The SASS (``cuobjdump -sass``) of the first function of ``lib`` whose
    name holds ``kernel``; None when cuobjdump or the function is
    missing."""
    tool = _cuobjdump()
    if tool is None:
        return None
    if lib not in _SASS:
        text = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        _SASS[lib] = re.split(r"\n\s*Function : ", text)[1:]
    funcs = [f for f in _SASS[lib] if kernel in f.split("\n", 1)[0]]
    return funcs[0] if funcs else None


# one SASS instruction: (predicate) opcode with its modifiers
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def sass_opcodes(lib, kernel):
    """{opcode with modifiers: count} over the whole SASS function of
    ``kernel`` in ``lib``; None when it cannot be read."""
    text = _sass_function(lib, kernel)
    if text is None:
        return None
    counts = {}
    for line in text.split("\n"):
        op = _SASS_OP.search(line)
        if op:
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return counts


def sass_blocks(lib, kernel):
    """The basic blocks (straight-line runs between labels and branches)
    of the first function of ``lib`` whose name holds ``kernel`` that run
    32 or more ex2 (a tile's softmax over 32 pairs a thread), largest
    first: [(instructions, {class: count})]. None when cuobjdump or the
    function is missing."""
    text = _sass_function(lib, kernel)
    if text is None:
        return None
    blocks, cur = [], []
    for line in text.split("\n"):
        if re.match(r"\s*\.L_x_\d+:", line):
            blocks.append(cur)
            cur = []
            continue
        op = _SASS_OP.search(line)
        if not op:
            continue
        opcode = op.group(1).split(".")[0]
        cur.append(opcode)
        if opcode in ("BRA", "EXIT", "BAR", "RET", "WARPSYNC", "BSYNC"):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    out = []
    for b in sorted(blocks, key=len, reverse=True):
        counts = {name: sum(op in ops for op in b)
                  for name, ops in _SASS_CLASSES}
        if counts["ex2"] >= 32:
            out.append((len(b), counts))
    return out


def _f32_fwd_sass(lib):
    """The f32 forward's products in SASS, per head dim: TF32 HMMAs (three
    m16n8k8 a product step in 3xTF32) against the f32 FFMAs of the whole
    function (the softmax's exponent folding; a product loop on the CUDA
    cores would take thousands a thread). Fails when an instantiation runs
    no TF32 HMMA or more FFMAs than HMMAs."""
    for d in (32, 64, 128, 256):
        ops = sass_opcodes(lib, f"flash_fwd_f32_kernelILb0ELi{d}E")
        if ops is None:
            log("build: cuobjdump or the f32 forward not found; its SASS not "
                "counted")
            return
        hmma = {k: n for k, n in ops.items() if k.startswith("HMMA")}
        tf32 = sum(n for k, n in hmma.items() if "TF32" in k)
        ffma = sum(n for k, n in ops.items() if k.split(".")[0] == "FFMA")
        other = {k: n for k, n in sorted(ops.items(), key=lambda x: -x[1])
                 if n >= 64 and not k.startswith("HMMA")}
        log(f"build: flash_fwd_f32_kernel<{d}> SASS: {sum(ops.values())} "
            f"instructions, HMMA {hmma}, FFMA {ffma}; opcodes with 64 or "
            f"more: {other}")
        check(tf32 > 0 and ffma < tf32,
              f"build: flash_fwd_f32_kernel<{d}> runs {tf32} TF32 HMMAs and "
              f"{ffma} FFMAs: its products are not on the tensor cores")


def _f32_bwd_sass(lib):
    """The f32 backward's products in SASS at D = 32 and 64 (the tensor-core
    kernels, plain and DENSE; dq with and without its key split): TF32
    HMMAs
    (three m16n8k8 a product step in 3xTF32) beside the FFMAs of the whole
    function (the softmax gradient's). Fails when an instantiation is not
    found or runs no TF32 HMMA; skipped only where the toolkit has no
    cuobjdump."""
    if _cuobjdump() is None:
        log("build: no cuobjdump; the f32 backward's SASS not counted")
        return
    for d, dense in ((32, 0), (64, 0), (32, 1), (64, 1)):
        flag = ("false", "true")[dense]
        for kern, targs, name in (
                ("flash_bwd_dq_f32_kernel", f"ILb{dense}ELi{d}ELi1EE",
                 f"{flag},{d},1"),
                ("flash_bwd_dq_f32_kernel", f"ILb{dense}ELi{d}ELi4EE",
                 f"{flag},{d},4"),
                ("flash_bwd_dkv_f32_kernel", f"ILb{dense}ELi{d}EE",
                 f"{flag},{d}")):
            ops = sass_opcodes(lib, kern + targs)
            check(ops is not None, f"build: {kern}<{name}> not found in {lib}")
            hmma = {k: n for k, n in ops.items() if k.startswith("HMMA")}
            tf32 = sum(n for k, n in hmma.items() if "TF32" in k)
            ffma = sum(n for k, n in ops.items()
                       if k.split(".")[0] == "FFMA")
            log(f"build: {kern}<{name}> SASS: {sum(ops.values())} "
                f"instructions, HMMA {hmma}, FFMA {ffma}")
            check(tf32 > 0, f"build: {kern}<{name}> runs no TF32 HMMA: its "
                  "products are not on the tensor cores")


# a tf32 warpgroup product in SASS: one HGMMA of 64 x N x 8
_HGMMA_TF32 = re.compile(r"HGMMA\.64x(\d+)x8\.F32\.TF32")


def _conv_f32_sass(lib):
    """#11's f32 kernel in SASS, per tile width: its products counted in
    m16n8k8 TF32 units a warp (an HGMMA.64xNx8 is N / 8 of them, an HMMA
    TF32 one) against the f32 FFMAs of the whole function (the epilogue's
    scale and shift; a product loop on the CUDA cores would take
    thousands). Fails when an instantiation is not found in the library,
    runs no TF32 HGMMA or HMMA, or more FFMAs than products; skipped only
    where the toolkit has no cuobjdump."""
    if _cuobjdump() is None:
        log("build: no cuobjdump; #11's f32 SASS not counted")
        return
    for bc in (64, 128):
        name = f"conv_bn_act_tf32_kernelILi{bc}E"
        text = _sass_function(lib, name)
        check(text is not None,
              f"build: {name} not found in {lib}: #11's f32 products unread")
        gmma = [int(n) for n in _HGMMA_TF32.findall(text)]
        ops = sass_opcodes(lib, name)
        hmma = sum(n for k, n in ops.items()
                   if k.startswith("HMMA") and "TF32" in k)
        ffma = sum(n for k, n in ops.items() if k.split(".")[0] == "FFMA")
        products = sum(n // 8 for n in gmma) + hmma
        log(f"build: conv_bn_act_tf32_kernel<{bc}> SASS: "
            f"{sum(ops.values())} instructions, {len(gmma)} TF32 HGMMA "
            f"(64 x {sorted(set(gmma))} x 8), {hmma} TF32 HMMA = {products} "
            f"m16n8k8 products a warp; FFMA {ffma}")
        check(products > 0 and ffma < products,
              f"build: conv_bn_act_tf32_kernel<{bc}> runs {products} TF32 "
              f"products and {ffma} FFMAs: its products are not on the "
              "tensor cores")


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    for name in _build.sources():
        check(os.path.exists(_build._lib_path(name)[1]),
              f"build: {name} produced no library")
        logtxt = built.get(name, (0, ""))[1]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", logtxt)]
        spills = [int(x) for x in
                  re.findall(r"(\d+) bytes spill stores", logtxt)]
        log(f"build: {name}: {len(regs)} kernels, max registers "
            f"{max(regs) if regs else 'n/a'}, max spill stores "
            f"{max(spills) if spills else 0} bytes")
        if name in ("flash_attention_fwd", "flash_attention_bwd",
                    "flash_decode", "paged_flash_decode", "fused_ln",
                    "conv_bn_act"):
            for kern, nreg, spill in _instantiations(logtxt):
                log(f"build:   {kern}: {nreg} registers, {spill} bytes "
                    "spill stores")
                # the LN backward and the f32 backward on the tensor
                # cores (plain and DENSE) must not spill
                check(not ((kern.startswith("ln_bwd")
                            or kern.startswith("flash_bwd_d")
                            and "_f32_kernel<" in kern) and spill),
                      f"build: {kern} spills {spill} bytes")
    # the forward's CUDA-core work: a tile's softmax is straight-line code
    # between its two products, over 32 (q, k) pairs a thread
    lib = _build._lib_path("flash_attention_fwd")[1]
    blocks = sass_blocks(lib,
                         "flash_fwd_tc_kernelILb0ELi64E13__nv_bfloat16E")
    if blocks is None:
        log("build: cuobjdump or the kernel not found; the forward's SASS "
            "count not measured")
    else:
        for n, counts in blocks:
            log(f"build: flash_fwd_tc_kernel<64,bf16> SASS basic block of "
                f"{n} instructions = {n / 32:.1f} a pair over 32 pairs a "
                f"thread: {counts}")
    # #10's leaf table is a __grid_constant__ parameter: copied into local
    # memory (a stack frame of its size) every thread would read it from
    # there
    adamw = built.get("fused_adamw", (0, ""))[1]
    frames = [int(x) for x in re.findall(r"(\d+) bytes stack frame", adamw)]
    log(f"build: adamw_kernel stack frames {frames} bytes")
    check(not adamw or (frames and max(frames) == 0),
          f"build: adamw_kernel keeps a {frames} byte stack frame")
    _f32_fwd_sass(lib)
    _f32_bwd_sass(_build._lib_path("flash_attention_bwd")[1])
    _conv_f32_sass(_build._lib_path("conv_bn_act")[1])
    log(f"build: {len(_build.sources())} sources in {secs:.2f} s "
        "(parallel nvcc, sm_90a)")
    return secs


def fwd_bound(dtype, bytes_moved, pairs, d):
    """(bound ms, what bounds it) of the flash forward over ``pairs``
    visible (q, k) pairs, 4 D FLOPs each: bf16 at the bf16 tensor-core
    peak; f32 at the f32 bar, which the tensor cores reach in 3xTF32 (three
    TF32 products a product, so three times the FLOPs at the TF32 peak)."""
    flops = 4 * d * pairs
    if dtype == "bfloat16":
        return bound(bytes_moved, flops, peak=BF16_FLOPS)
    return bound(bytes_moved, 3 * flops, peak=TF32_FLOPS)


def f32_fwd_hmmas(bh_lens, sq, sk, d, causal):
    """The m16n8k8 TF32 HMMAs the f32 forward issues (csrc/
    flash_attention_fwd.cu): a warp owns 16 query rows and runs the key
    tiles (64 keys, 32 at D=256) below its own key end, each tile three
    products (3xTF32) of S = Q.K^T and of O += P.V; ``bh_lens`` holds each
    batch*head's key length."""
    bk = 32 if d == 256 else 64
    per_tile = 6 * (d // 8) * (bk // 8)
    tiles = 0
    for kv_len in bh_lens:
        for wq0 in range(0, sq, 16):
            end = kv_len
            if causal:
                end = min(end, min(wq0 + 15, sq - 1) + sk - sq + 1)
            tiles += max(0, -(-end // bk))
    return tiles * per_tile


def _flash_case(torch, b, h, sq, sk, d, dtype, lens, gen, flush,
                timed, dropout=0.0, causal=True):
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    dt = getattr(torch, dtype)
    mk = lambda s: torch.randn(b * h, s, d, generator=gen,  # noqa: E731
                               device="cuda").to(dt)
    q, k, v = mk(sq), mk(sk), mk(sk)
    lens_t = None if lens is None else torch.tensor(
        [x for x in lens for _ in range(h)], dtype=torch.int32,
        device="cuda")
    seed = torch.tensor([4321], dtype=torch.int32, device="cuda")
    rest = (lens_t, seed, causal, None, dropout)
    o, lse = kfa.flash_attention_fwd(q, k, v, *rest)
    torch.cuda.synchronize()
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, *rest)
    err = (o.float() - po.float()).abs().max().item()
    lerr = (lse - plse).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"flash {dtype} b{b} h{h} sq{sq} sk{sk} d{d} lens{lens} dropout"
          f"{dropout}: max_abs_err {err} > {TOL[dtype]}")
    check(math.isfinite(lerr) and lerr <= 1e-3,
          f"flash lse b{b} sq{sq} sk{sk}: max_abs_err {lerr}")
    _check_repeat_fwd(torch, f"flash {dtype} b{b} sq{sq} sk{sk} d{d}", o,
                      lse, lambda: kfa.flash_attention_fwd(q, k, v, *rest))
    row = dict(dtype=dtype, b=b, h=h, sq=sq, sk=sk, d=d, lens=lens,
               dropout=dropout, causal=causal, max_abs_err=err)
    if timed:
        row["ms"] = time_ms(torch, lambda: kfa.flash_attention_fwd(
            q, k, v, *rest), flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: kfa.flash_attention_fwd_plain(
            q, k, v, *rest), flush=flush)
        # torch SDPA on the same function, as the yardstick
        qt, kt, vt = (x.view(b, h, -1, d) for x in (q, k, v))
        qpos = torch.arange(sq, device="cuda")[:, None]
        kpos = torch.arange(sk, device="cuda")[None, :]
        keep = (kpos <= qpos + (sk - sq))[None, None] if causal else None
        if lens is not None:
            lkeep = kpos[None, None] < torch.tensor(
                lens, device="cuda")[:, None, None, None]
            keep = lkeep if keep is None else keep & lkeep
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=keep, dropout_p=dropout), flush=flush)
        # work this run's data needs: visible (q, k) pairs, causal + lens
        vis = h * visible_pairs(b, sq, sk, lens, causal)
        esz = q.element_size()
        bytes_moved = (b * h * (sq + 2 * sk) * d * esz  # q, k, v read
                       + b * h * sq * d * esz            # o written
                       + b * h * sq * 4)                 # lse written
        row["flops"] = 4 * d * vis
        row["bound_ms"], row["bound_by"] = fwd_bound(dtype, bytes_moved, vis,
                                                     d)
        # the same work's bound on the CUDA cores, the f32 kernel's before
        # it ran 3xTF32
        row["cuda_core_bound_ms"] = bound(bytes_moved, row["flops"])[0]
    return row


def _check_repeat_fwd(torch, where, o, lse, fwd):
    """The forward uses no atomics: a second call gives o and lse bit for
    bit."""
    o2, lse2 = fwd()
    torch.cuda.synchronize()
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          f"{where}: a second forward gave another o or lse")


def phase_flash(torch, flush):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for s in (64, 128, 512, 1024):
        lens = [s - 1 - s // 10]
        for dtype in ("float32", "bfloat16"):
            rows.append(_flash_case(torch, 1, 16, s, s, 64, dtype,
                                    lens, gen, flush,
                                    timed=dtype == "float32"))
    rows.append(_flash_case(torch, 1, 16, 256, 256, 128, "float32",
                            [200], gen, flush, False))
    rows.append(_flash_case(torch, 2, 4, 96, 320, 64, "float32",
                            [320, 150], gen, flush, False))
    rows.append(_flash_case(torch, 2, 4, 64, 64, 64, "float32",
                            [0, 64], gen, flush, False))
    # f32 (3xTF32) at every head dim, with dropout 0.1 and without: 64-row
    # blocks and 64-key tiles (32 at D=256) cut raggedly, kv_lens 0
    for d in (64, 128, 256):
        for dropout in (0.0, 0.1):
            rows.append(_flash_case(torch, 3, 2, 200, 330, d, "float32",
                                    [0, 330, 97], gen, flush, False,
                                    dropout))
    # the bf16 kernel at D=256 (one warpgroup, output columns over two
    # blocks) and with one query row
    rows.append(_flash_case(torch, 2, 4, 300, 300, 256, "bfloat16",
                            [300, 170], gen, flush, False))
    rows.append(_flash_case(torch, 4, 8, 1, 576, 64, "bfloat16",
                            [576, 1, 0, 300], gen, flush, False))
    rows.append(_flash_case(torch, 2, 8, 1, 200, 128, "bfloat16",
                            [200, 65], gen, flush, False))
    _check_keep_mask(torch, 256, 256, "float32", gen)
    _log_fwd_rows("flash", rows)
    return rows


def _log_fwd_rows(tag, rows):
    """One line a forward case: its error and, for a timed case, kernel,
    twin and SDPA ms against the bound."""
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} (unheld {unheld(r['ms']):.4f}) plain_ms "
            f"{r['plain_ms']:.4f} sdpa_ms {r['library_ms']:.4f} (unheld "
            f"{unheld(r['library_ms']):.4f}) bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}; the CUDA-core bound "
            f"{r['cuda_core_bound_ms']:.4f}): "
            f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.3f} of the bound")
        log(f"{tag}: {r['dtype']} b{r['b']} h{r['h']} sq{r['sq']} "
            f"sk{r['sk']} d{r['d']} lens{r['lens']} dropout{r['dropout']} "
            f"causal={r['causal']} max_abs_err {r['max_abs_err']:.3e}"
            f"{extra}")


def _paged_module():
    """ops/kernels/flash_decode.py, the paged decode's module (the package
    attribute of that name is the dense decode wrapper)."""
    import importlib
    return importlib.import_module("paddle_tpu_torch.ops.kernels.flash_decode")


def _decode_inputs(torch, b, hkv, g, d, ps, mp, dtype, lens, gen,
                   q_dtype="float32"):
    """(q, k pool, v pool, page table, lens, k scales, v scales) of a paged
    decode call: each slot owns its own pages, entries past its pages are
    the trash page 0."""
    from paddle_tpu_torch.nlp.paged_cache import quantize_rows
    num_pages = b * mp + 1
    q = torch.randn(b, hkv, g, d, generator=gen, device="cuda").to(
        getattr(torch, q_dtype))
    kf = torch.randn(hkv, num_pages, ps, d, generator=gen, device="cuda")
    vf = torch.randn(hkv, num_pages, ps, d, generator=gen, device="cuda")
    ks = vs = None
    if dtype == "int8":
        kp, ks = quantize_rows(kf)
        vp, vs = quantize_rows(vf)
    else:
        kp, vp = kf.to(getattr(torch, dtype)), vf.to(getattr(torch, dtype))
    del kf, vf
    pt = (1 + torch.randperm(b * mp, generator=gen, device="cuda")
          .view(b, mp)).int()
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    used = (lens_t.long() + ps - 1) // ps
    pt = torch.where(torch.arange(mp, device="cuda")[None] < used[:, None],
                     pt, torch.zeros_like(pt)).contiguous()
    return q, kp, vp, pt, lens_t, ks, vs


def _decode_bytes(b, hkv, g, d, lens, kp, pt, quant, q_size=4):
    """Bytes a paged decode call must move: q read and out written (in q's
    dtype, of ``q_size`` bytes), the live K and V rows (and their int8
    scales), the table and lens."""
    keys = int(sum(lens))
    return (2 * b * hkv * g * d * q_size
            + 2 * hkv * keys * d * kp.element_size()
            + (2 * hkv * keys * 4 if quant else 0) + pt.numel() * 4 + b * 4)


def _decode_case(torch, b, hkv, g, d, ps, mp, dtype, lens, gen, flush,
                 timed, q_dtype="float32"):
    """#5 vs its twin on one input of ``dtype`` pools and ``q_dtype`` q
    (and out): the pools' bar for f32 q, float16's (of max(1, |twin|))
    for float16 q."""
    from paddle_tpu_torch.nlp.paged_cache import paged_attention_ref
    kpd = _paged_module()
    q, kp, vp, pt, lens_t, ks, vs = _decode_inputs(torch, b, hkv, g, d, ps,
                                                   mp, dtype, lens, gen,
                                                   q_dtype)
    call = lambda: kpd.paged_flash_decode(  # noqa: E731
        q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs)
    out = call()
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs)
    err, scaled = _err(out, ref)
    where = (f"decode {dtype} pools, {q_dtype} q, b{b} hkv{hkv} g{g} d{d} "
             f"ps{ps} mp{mp}")
    half = q_dtype == "float16"
    tol = TOL["float16" if half else dtype]
    check(out.dtype == q.dtype and math.isfinite(err)
          and (scaled if half else err) <= tol,
          f"{where}: {out.dtype} out, max_abs_err {err} (of max(1, |twin|):"
          f" {scaled}) over {tol}")
    zero = [i for i, n in enumerate(lens) if n == 0]
    check(not out[zero].any().item() if zero else True,
          f"{where}: a lens-0 slot gave a nonzero row")
    # the combine runs in a fixed chunk order: a second call is bit-equal
    out2 = call()
    torch.cuda.synchronize()
    check(torch.equal(out, out2), f"{where}: a second call gave another "
          "output")
    row = dict(dtype=dtype, q_dtype=q_dtype, b=b, hkv=hkv, g=g, d=d, ps=ps,
               mp=mp, max_abs_err=err, scaled_err=scaled,
               split=kpd.paged_decode_split(b, hkv, g, mp, ps))
    if timed:
        row["ms"] = time_ms(torch, call, flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: paged_attention_ref(
            q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs), flush=flush)
        row["bound_ms"], row["bound_by"] = bound(
            _decode_bytes(b, hkv, g, d, lens, kp, pt, ks is not None,
                          q.element_size()),
            4 * hkv * g * d * int(sum(lens)))
    return row


PAGED_KERNELS = ("paged_decode_kernel",)


def _graph_nodes(torch, call, calls):
    """What ``calls`` calls of ``call`` put on the device, read from a CUDA
    graph captured around them: one entry a graph node, a kernel node by
    its kernel's mangled name, any other node (memset, copy, ...) as
    ``<node type N>``. Capture records every launch on the stream, so the
    list is exact where a profiler's record can be lost."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(err, what):
        check(err == 0, f"CUDA driver {what} returned error {err}")

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        for _ in range(calls):
            call()
    graph = vp(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2",
                         cu.cuGraphKernelNodeGetParams)
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            out.append(f"<node type {kind.value}>")
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2 in words: func, 3.5 words of grid,
        # block and smem, kernelParams, extra, kern, ctx (room to spare)
        params = (vp * 16)()
        ok(get_params(vp(node), params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(params[0])),
               "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(params[7])),
               "cuKernelGetName")
        out.append(name.value.decode())
    del g
    torch.cuda.synchronize()
    return out


def _check_one_kernel(torch, tag, call, names, calls=4):
    """``calls`` calls of ``call`` (a kernel wrapper whose scratch is
    already made) put exactly one kernel each on the device, one of
    ``names``, and nothing else.

    The count is read from a CUDA graph captured around the calls
    (_graph_nodes), which is exact. The calls then run eagerly under
    torch.profiler as well: every device kernel it records must be one of
    ``names``, and no more of them than calls. The profiler can lose a
    kernel's record (it lost one of four in each of three profiles in a
    row on an H100), so a profile recording fewer is taken again, at most
    twice more, and if all three fall short that is logged, not failed:
    the count stands on the graph. Each profile opens
    and closes with a 5 ms spin kernel (torch.cuda._sleep, not counted),
    so the calls' kernels lie well inside the profile's window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    nodes = _graph_nodes(torch, call, calls)
    ours = [n for n in nodes if any(d in n for d in names)]
    check(len(nodes) == calls and len(ours) == calls,
          f"{tag}: {calls} calls captured {len(nodes)} graph nodes {nodes}")
    spin = int(5 * _spin_rate(torch))
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(spin)
            for _ in range(calls):
                call()
            torch.cuda._sleep(spin)
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        kernels = {a.key: a.count for a in avgs
                   if a.device_type == DeviceType.CUDA
                   and "spin_kernel" not in a.key}
        spins = sum(a.count for a in avgs if a.device_type == DeviceType.CUDA
                    and "spin_kernel" in a.key)
        recorded = sum(kernels.values())
        mine = sum(c for n, c in kernels.items() if any(d in n for d in names))
        check(mine == recorded <= calls,
              f"{tag}: {calls} calls ran {kernels} on the device (profile "
              f"{attempt})")
        if recorded == calls:
            break
    log(f"{tag}: {calls} calls captured as {calls} kernel nodes, "
        f"{ours[0]}; under the profiler (profile {attempt}) {recorded} of "
        f"their kernels recorded, none other, and {spins} of 2 spins: "
        f"{kernels}")


def _check_paged_no_sync(torch):
    """One launch a call, and no call syncs with the host: 4 calls at the
    serving shape (slots spanning several chunks) under the profiler, then
    one under torch.cuda's sync debug mode set to raise on a sync."""
    kpd = _paged_module()
    gen = torch.Generator(device="cuda").manual_seed(3)
    lens = [576, 65, 300, 1024, 0, 208, 417, 16]
    q, kp, vp, pt, lens_t, _, _ = _decode_inputs(torch, 8, 16, 1, 64, 16,
                                                 64, "float32", lens, gen)
    call = lambda: kpd.paged_flash_decode(q, kp, vp, pt, lens_t)  # noqa
    _check_one_kernel(torch, "decode", call, PAGED_KERNELS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("decode: a call under the sync debug mode 'error' raised nothing: "
        "the wrapper does not sync")


def phase_decode(torch, flush):
    import numpy as np
    kpd = _paged_module()
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b in (8, 32):
        # the slice's lengths: prompts 64..512 plus up to 64 new tokens
        lens = rng.integers(65, 577, b).tolist()
        for dtype in ("float32", "bfloat16", "int8"):
            rows.append(_decode_case(torch, b, 16, 1, 64, 16, 64, dtype,
                                     lens, gen, flush, timed=True))
    rows.append(_decode_case(torch, 8, 4, 4, 64, 16, 64, "float32",
                             rng.integers(1, 1025, 8).tolist(), gen, flush,
                             timed=True))
    # lens 0, exactly on page boundaries, one key, the full table
    edge = [0, 16, 32, 1, 1024, 0, 160, 17]
    for dtype in ("float32", "int8"):
        rows.append(_decode_case(torch, 8, 16, 1, 64, 16, 64, dtype, edge,
                                 gen, flush, timed=False))
    # the split's edges: slots ending exactly on a chunk boundary and one
    # key either side of it; one slot with the full 1024 keys, the rest 0;
    # one slot (many chunks of a row, combined in the launch)
    _, ppc = kpd.paged_decode_split(8, 16, 1, 64, 16)
    ck = ppc * 16
    chunk_edge = [ck, 2 * ck, ck - 1, ck + 1, 3 * ck, 1, 2 * ck + 1, 1024]
    for dtype in ("float32", "bfloat16", "int8"):
        rows.append(_decode_case(torch, 8, 16, 1, 64, 16, 64, dtype,
                                 chunk_edge, gen, flush, timed=False))
        rows.append(_decode_case(torch, 8, 16, 1, 64, 16, 64, dtype,
                                 [0] * 7 + [1024], gen, flush, timed=False))
        rows.append(_decode_case(torch, 1, 16, 1, 64, 16, 64, dtype, [777],
                                 gen, flush, timed=False))
    # every head dim and pool (16-byte rows of 4 to 32 lanes, two chunks a
    # lane for f32 at D=256), GQA groups of 4 and a ragged last group, a
    # page size that does not divide a warp's step
    for d in (128, 256):
        for dtype in ("float32", "bfloat16", "int8"):
            rows.append(_decode_case(torch, 4, 2, 1, d, 16, 32, dtype,
                                     [512, 0, 77, 300], gen, flush,
                                     timed=False))
            rows.append(_decode_case(torch, 3, 2, 6, d, 16, 32, dtype,
                                     [100, 512, 17], gen, flush,
                                     timed=False))
    for dtype in ("float32", "int8"):
        rows.append(_decode_case(torch, 4, 4, 4, 64, 7, 40, dtype,
                                 [280, 6, 7, 141], gen, flush, timed=False))
    _check_paged_no_sync(torch)
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} (unheld {unheld(r['ms']):.4f}) plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}): {r['bound_ms'] / r['ms']:.3f} of the bound")
        log(f"decode: {r['dtype']} b{r['b']} hkv{r['hkv']} g{r['g']} "
            f"d{r['d']} ps{r['ps']} mp{r['mp']} (splits, pages a chunk) "
            f"{r['split']} max_abs_err {r['max_abs_err']:.3e}{extra}")
    return rows


def phase_slice(torch):
    import numpy as np
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    from paddle_tpu_torch.nlp.serving import ServingEngine
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    cfg = _resolve_config("gpt3-345M")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=seed(0)).eval()
    torch.cuda.synchronize()
    log(f"slice: gpt3-345M built on cuda in {time.perf_counter() - t0:.2f}"
        f" s ({sum(p.numel() for p in model.parameters())} parameters, "
        f"hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size})")
    rng = np.random.default_rng(0)
    lens = [64 + (448 * i) // 15 for i in range(16)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    new = 64
    eng_kw = dict(max_slots=8, page_size=16, max_seq_len=1024)
    eng = ServingEngine(model, device="cuda", **eng_kw)
    eng.generate([prompts[0][:32]], max_new_tokens=2)   # warm-up
    eng.reset_counters()

    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(p, new) for p in prompts]
    res = {r["id"]: r for r in eng.run_to_completion()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    log(f"slice: kernel launches in the serving path: {launches}")
    for name in ("flash_attention_fwd", "paged_flash_decode"):
        check(launches[name] > 0,
              f"slice: kernel {name} never launched on the serving path")
    check(eng.free_page_count == eng.num_pages - 1,
          f"slice: free pages {eng.free_page_count} != "
          f"{eng.num_pages - 1} after the run")
    toks = [res[i]["tokens"] for i in ids]
    for t in toks:
        check(len(t) == new and all(0 <= x < cfg.vocab_size for x in t),
              f"slice: bad token stream {t[:8]}...")
    ttft = sorted(res[i]["ttft_s"] for i in ids)
    ttft_p50 = float(np.percentile(ttft, 50))
    tok_s = eng.decode_tokens / eng.decode_seconds
    log(f"slice: served {len(ids)} requests x {new} tokens in {wall:.3f} s;"
        f" TTFT p50 {ttft_p50 * 1e3:.2f} ms (min {ttft[0] * 1e3:.2f}, max "
        f"{ttft[-1] * 1e3:.2f}); decode {eng.decode_tokens} tokens in "
        f"{eng.decode_seconds:.3f} s over {eng.decode_dispatches} "
        f"dispatches = {tok_s:.1f} tokens/s")

    busy_share = profile_decode(torch, eng, prompts)

    # the same weights on the CPU: 2 of the requests again
    cpu = GPTForCausalLM(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pick = [0, 1]
    with torch.no_grad():
        for i in pick:
            p = prompts[i]
            bucket = eng._bucket_for(len(p))
            x = np.zeros((1, bucket), np.int32)
            x[0, :len(p)] = p
            rows = []
            for m, dev in ((model, "cuda"), (cpu, "cpu")):
                lg = m(torch.from_numpy(x).to(dev), kv_lens=torch.tensor(
                    [len(p)], dtype=torch.int32, device=dev))
                rows.append(lg[0, len(p) - 1].float().cpu())
            err = (rows[0] - rows[1]).abs().max().item()
            check(torch.isfinite(rows[0]).all().item() and err <= 1e-3,
                  f"slice: prefill last-row logits differ by {err} "
                  f"between cuda and cpu (request {i})")
            log(f"slice: request {i} (prompt {len(p)}, bucket {bucket}): "
                f"prefill last-row logits cuda vs cpu max_abs_err "
                f"{err:.3e}")
    cpu_eng = ServingEngine(cpu, device="cpu", **dict(eng_kw, max_slots=2))
    cpu_toks = cpu_eng.generate([prompts[i] for i in pick],
                                max_new_tokens=new)
    agree = total = 0
    for i, ct in zip(pick, cpu_toks):
        check(ct[0] == toks[i][0], f"slice: first token differs cuda "
              f"{toks[i][0]} vs cpu {ct[0]} (request {i})")
        agree += sum(a == b for a, b in zip(ct, toks[i]))
        total += len(ct)
    log(f"slice: greedy tokens cuda vs cpu agree on {agree}/{total} "
        f"({agree / total:.3f}); first tokens equal")
    return dict(launches=launches, ttft_p50_s=ttft_p50, decode_tok_s=tok_s,
                wall_s=wall, decode_busy_share=busy_share)


def profile_decode(torch, eng, prompts):
    """One full-pool decode dispatch (8 live slots x steps_per_dispatch
    tokens) under torch.profiler: the device's busy share of the
    dispatch's wall time and the kernels that take the device time. The
    profiler's own host cost makes the wall longer, so the share is a
    lower bound."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.max_slots]:
        eng.submit(p[:64], 1 + 3 * eng.steps_per_dispatch)
    eng.step()                      # admissions + the first dispatch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_to_completion()
    from torch.autograd import DeviceType
    # device-side rows only: the CPU ops that launched them carry the
    # same time again as their own self device time
    rows = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    busy = sum(a.self_device_time_total for a in rows) / 1e6
    if busy <= 0:
        log("profile: the profiler recorded no device time; decode busy "
            "share not measured")
        return None
    log(f"profile: one decode dispatch ({eng.max_slots} slots x "
        f"{eng.steps_per_dispatch} steps): wall {wall * 1e3:.3f} ms under "
        f"the profiler, device busy {busy * 1e3:.3f} ms = "
        f"{busy / wall:.3f} of it")
    for a in rows[:8]:
        log(f"profile:   {a.self_device_time_total / 1e3:9.3f} ms  "
            f"x{a.count:<5d} {a.key[:90]}")
    return busy / wall


# -- training: flash backward, AdamW, the slice -------------------------------

def _err(a, b):
    """(max |a - b|, max |a - b| / max(1, |b|)) in f32."""
    diff = (a.float() - b.float()).abs()
    return (diff.max().item(),
            (diff / b.float().abs().clamp_min(1.0)).max().item())


def f16_ulps(a, b):
    """The largest |a - b| in float16 ulps of max(1, |b|) over b's finite
    places (inf where a and b are not non-finite at the same places)."""
    af, bf = a.float(), b.float()
    fin = bf.isfinite()
    if not (bool((af.isfinite() == fin).all())
            and bool((af.isposinf() == bf.isposinf()).all())):
        return math.inf
    if not bool(fin.any()):
        return 0.0
    # float16's ulp at max(1, |b|): 2^(e - 10) for e = floor(log2)
    ulp = (bf[fin].abs().clamp_min(1.0).log2().floor() - 10).exp2()
    return ((af[fin] - bf[fin]).abs() / ulp).max().item()


def _check_grad(name, dtype, a, b, where):
    err, scaled = _err(a, b)
    ok = err <= TOL[dtype] if dtype == "float32" else scaled <= TOL[dtype]
    check(math.isfinite(err) and ok,
          f"flash-train {where}: {name} max_abs_err {err} (of max(1, "
          f"|twin|): {scaled}) over the {dtype} tolerance {TOL[dtype]}")
    return err


def _flash_train_case(torch, b, h, sq, sk, d, dtype, lens, dropout, gen,
                      flush, timed, causal=True, kv_heads=None):
    """The three flash kernels vs their twins on one input; the backward
    twins take the kernels' own forward outputs (o, lse) and the dq
    kernel's delta, so each kernel is held against its twin on the same
    inputs. ``kv_heads``: k and v drawn with that many heads and expanded
    to ``h`` (query head i reads kv head i // (h / kv_heads)), contiguous,
    as a GQA model's attention hands them to the kernels."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    dt = getattr(torch, dtype)
    mk = lambda s, n=h: torch.randn(b * n, s, d,  # noqa: E731
                                    generator=gen, device="cuda").to(dt)
    q, k, v, do = mk(sq), mk(sk, kv_heads or h), mk(sk, kv_heads or h), \
        mk(sq)
    if kv_heads:
        k, v = (x.view(b, kv_heads, sk, d).repeat_interleave(
            h // kv_heads, dim=1).reshape(b * h, sk, d) for x in (k, v))
    lens_t = None if lens is None else torch.tensor(
        [x for x in lens for _ in range(h)], dtype=torch.int32,
        device="cuda")
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    rest = (lens_t, seed, causal, None, dropout)
    o, lse = kfa.flash_attention_fwd(q, k, v, *rest)
    dq, delta = kfa.flash_attention_bwd_dq(q, k, v, o, do, lse, *rest)
    dk, dv = kfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *rest)
    torch.cuda.synchronize()
    where = (f"{dtype} b{b} h{h} sq{sq} sk{sk} d{d} lens{lens} "
             f"dropout{dropout} causal={causal}"
             + (f" kv_heads{kv_heads}" if kv_heads else ""))
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, *rest)
    pdq, pdelta = kfa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse,
                                                   *rest)
    pdk, pdv = kfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 *rest)
    row = dict(dtype=dtype, b=b, h=h, sq=sq, sk=sk, d=d, lens=lens,
               dropout=dropout, causal=causal, kv_heads=kv_heads)
    row["err"] = {n: _check_grad(n, dtype, a, p, where) for n, a, p in (
        ("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv))}
    # lse as phase 2 holds it; delta, a sum of D products, to 1e-4 of
    # max(1, |twin|)
    e = _err(lse, plse)[0]
    check(math.isfinite(e) and e <= 1e-3,
          f"flash-train {where}: lse max_abs_err {e}")
    e2, scaled = _err(delta, pdelta)
    check(math.isfinite(scaled) and scaled <= 1e-4,
          f"flash-train {where}: delta max_abs_err {e2} ({scaled} of "
          "max(1, |twin|))")
    row["err"].update(lse=e, delta=e2)
    del po, pdq, pdk, pdv
    # no atomics: a second backward repeats the first bit for bit
    dq2, delta2 = kfa.flash_attention_bwd_dq(q, k, v, o, do, lse, *rest)
    dk2, dv2 = kfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *rest)
    torch.cuda.synchronize()
    for n, a, a2 in (("dq", dq, dq2), ("delta", delta, delta2),
                     ("dk", dk, dk2), ("dv", dv, dv2)):
        check(torch.equal(a, a2), f"flash-train {where}: a second backward "
              f"gave another {n}")
    del dq2, delta2, dk2, dv2
    _check_repeat_fwd(torch, f"flash-train {where}", o, lse,
                      lambda: kfa.flash_attention_fwd(q, k, v, *rest))
    if not timed:
        return row
    fwd = lambda: kfa.flash_attention_fwd(q, k, v, *rest)  # noqa: E731
    kern = {"fwd": fwd,
            "dq": lambda: kfa.flash_attention_bwd_dq(
                q, k, v, o, do, lse, *rest),
            "dkv": lambda: kfa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, *rest)}
    plain = {"fwd": lambda: kfa.flash_attention_fwd_plain(q, k, v, *rest),
             "dq": lambda: kfa.flash_attention_bwd_dq_plain(
                 q, k, v, o, do, lse, *rest),
             "dkv": lambda: kfa.flash_attention_bwd_dkv_plain(
                 q, k, v, do, lse, delta, *rest)}
    row["ms"] = {n: time_ms(torch, f, flush=flush) for n, f in kern.items()}
    row["plain_ms"] = {n: time_ms(torch, f, flush=flush)
                       for n, f in plain.items()}
    # torch SDPA on the same function, as the yardstick: its forward for
    # the forward kernel, its backward (dq, dk and dv in one call) for each
    # of the two backward kernels
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.view(b, h, -1, d).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = lambda: sdpa(qt, kt, vt, is_causal=causal,  # noqa: E731
                           dropout_p=dropout)
    out = lib_fwd()
    dout = do.view(b, h, sq, d)
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, (qt, kt, vt), dout, retain_graph=True)
    with torch.no_grad():
        lib_fwd_ms = time_ms(torch, lib_fwd, flush=flush)
    lib_bwd_ms = time_ms(torch, lib_bwd, flush=flush)
    row["library_ms"] = {"fwd": lib_fwd_ms, "dq": lib_bwd_ms,
                         "dkv": lib_bwd_ms}
    del out, qt, kt, vt
    work = flash_work(b, h, sq, sk, d, q.element_size(), lens, causal)
    # bf16 at the bf16 tensor-core peak; f32 at the f32 bar, which the
    # tensor cores reach in 3xTF32 (three TF32 products a product at the
    # TF32 peak), the CUDA cores' bound beside it
    row["bound"] = {n: flash_bound(dtype, n, *w) for n, w in work.items()}
    if dtype == "float32":
        row["bound_cores"] = {n: bound(*work[n], peak=F32_FLOPS)
                              for n in ("dq", "dkv")}
    row["flops"] = {n: w[1] for n, w in work.items()}
    return row


def flash_work(b, h, sq, sk, d, esz, lens, causal):
    """{kernel: (bytes, FLOPs)} of the flash forward ("fwd"), dq and dk/dv
    over the visible (q, k) pairs, each input read once and each output
    written once: 4 D FLOPs a pair forward, 6 D for dq, 8 D for dk/dv."""
    pairs = h * visible_pairs(b, sq, sk, lens, causal)  # over every head
    nq, nk = b * h * sq * d, b * h * sk * d
    stat = b * h * sq * 4
    return {
        "fwd": ((nq + 2 * nk + nq) * esz + stat, 4 * d * pairs),
        "dq": ((3 * nq + 2 * nk + nq) * esz + 2 * stat, 6 * d * pairs),
        "dkv": ((2 * nq + 2 * nk + 2 * nk) * esz + 2 * stat, 8 * d * pairs),
    }


def flash_bound(dtype, kernel, bytes_moved, flops):
    """(bound ms, what bounds it) of a flash kernel: bf16 and f16 at the
    16-bit tensor-core peak (989 TFLOP/s both), f32 in 3xTF32 (three times
    the FLOPs at the TF32 peak)."""
    if dtype in ("bfloat16", "float16"):
        return bound(bytes_moved, flops, peak=BF16_FLOPS)
    return bound(bytes_moved, 3 * flops, peak=TF32_FLOPS)


def _f64_bwd(torch, q, k, v, o, lse, do, causal, keep=None, rate=0.0):
    """The backward's function in float64 from the kernels' own f32 inputs
    (q, k, v [BH, S, D]; o and dO; the forward's lse): (dq, dk, dv) with
    delta = rowsum(dO * o), p = exp(q.k * scale - lse) masked by the
    bottom-right causal rule, dp and p dropped by ``keep``."""
    qd, kd, vd, od, dod = (x.double() for x in (q, k, v, o, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(qd, kd.transpose(1, 2)) * scale
                  - lse.double()[..., None])
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        pos = torch.arange(max(sq, sk), device=q.device)
        p = p.masked_fill(pos[None, :sk] > pos[:sq, None] + (sk - sq), 0.0)
    dp = torch.matmul(dod, vd.transpose(1, 2))
    pd = p
    if keep is not None:
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    ds = p * (dp - (dod * od).sum(-1, keepdim=True))
    del p, dp
    return (torch.matmul(ds, kd) * scale,
            torch.matmul(ds.transpose(1, 2), qd) * scale,
            torch.matmul(pd.transpose(1, 2), dod))


def _from_f64(got, want):
    """max |got - want| / max(1, |want|) of each pair, got f32 and want
    float64."""
    return [((a.double() - w).abs() / w.abs().clamp(min=1.0)).max().item()
            for a, w in zip(got, want)]


def _check_keep_mask(torch, s, d, dtype, gen):
    """With V the identity (sk = D), the forward kernel's o is the dropped
    probability matrix divided by its row sum: its zeros are exactly the
    dropped or masked entries, which must be the twin's keep mask."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    bh, rate = 4, 0.1
    dt = getattr(torch, dtype)
    q = torch.randn(bh, s, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(bh, s, d, generator=gen, device="cuda").to(dt)
    v = torch.eye(s, device="cuda").expand(bh, s, d).contiguous().to(dt)
    seed = torch.tensor([987654], dtype=torch.int32, device="cuda")
    o, _ = kfa.flash_attention_fwd(q, k, v, None, seed, True, None, rate)
    keep = kfa.dropout_keep(seed, bh, s, s, rate, "cuda")
    visible = kfa._visible(s, s, None, True, "cuda")
    want_zero = ~(keep & visible)
    same = torch.equal(o == 0, want_zero)
    check(same, f"flash-train: forward keep mask differs from the twin's "
          f"({dtype}, S={s}, D={d}): {(o == 0).ne(want_zero).sum().item()} "
          "entries")
    po, _ = kfa.flash_attention_fwd_plain(q, k, v, None, seed, True, None,
                                          rate)
    check(torch.equal(po == 0, want_zero), "flash-train: the twin's zeros "
          "are not its keep mask")
    log(f"flash-train: keep mask {dtype} S={s} D={d}: kernel zeros == "
        f"twin keep mask on all {want_zero.numel()} entries "
        f"({want_zero.float().mean().item():.4f} dropped or masked)")


def phase_flash_train(torch, flush):
    gen = torch.Generator(device="cuda").manual_seed(5)
    _check_keep_mask(torch, 64, 64, "float32", gen)
    _check_keep_mask(torch, 128, 128, "bfloat16", gen)
    rows = []
    for dropout in (0.0, 0.1):
        for dtype in ("float32", "bfloat16"):
            rows.append(_flash_train_case(torch, 8, 16, 1024, 1024, 64,
                                          dtype, None, dropout, gen, flush,
                                          timed=True))
    # GPT-1.3B's training shape: 16 heads of 128 at batch 4 x 1024
    rows.append(_flash_train_case(torch, 4, 16, 1024, 1024, 128, "bfloat16",
                                  None, 0.1, gen, flush, timed=True))
    for dtype in ("float32", "bfloat16"):
        rows.append(_flash_train_case(torch, 2, 4, 256, 256, 64, dtype,
                                      [200, 256], 0.1, gen, flush, False))
    rows += [
        _flash_train_case(torch, 2, 2, 64, 64, 64, "float32", [0, 64], 0.1,
                          gen, flush, False),
        _flash_train_case(torch, 2, 4, 96, 320, 64, "float32", [320, 150],
                          0.1, gen, flush, False),
        _flash_train_case(torch, 1, 4, 320, 96, 64, "float32", None, 0.0,
                          gen, flush, False),
        _flash_train_case(torch, 1, 8, 256, 256, 128, "float32", [200], 0.1,
                          gen, flush, False),
        _flash_train_case(torch, 1, 8, 256, 256, 128, "bfloat16", None, 0.1,
                          gen, flush, False),
        _flash_train_case(torch, 1, 2, 64, 64, 256, "float32", [50], 0.1,
                          gen, flush, False),
    ]
    # the bf16 kernels' tiles (64 rows streamed, 128 owned, 64 at D=256)
    # cut raggedly: sq and sk on either side of tile edges, sq != sk under
    # causal both ways, kv_lens of 0, mid-tile and sk; dropout 0.1
    for d in (64, 128, 256):
        for sq, sk, causal in RAGGED_SHAPES:
            lens = None if sq == sk else [0, sk // 2 + 1, sk]
            rows.append(_flash_train_case(
                torch, 1 if lens is None else 3, 2, sq, sk, d, "bfloat16",
                lens, 0.1, gen, flush, False, causal=causal))
    _log_flash_rows("flash-train", rows)
    return rows


# (sq, sk, causal) of phase 5's ragged bf16 cases
RAGGED_SHAPES = ((1, 63, True), (63, 1, True), (65, 127, True),
                 (127, 65, True), (129, 1000, True), (1000, 129, True),
                 (1000, 1000, True), (65, 1000, False), (127, 129, False))


def _log_flash_rows(tag, rows):
    for r in rows:
        errs = " ".join(f"{n} {e:.2e}" for n, e in r["err"].items())
        log(f"{tag}: {r['dtype']} b{r['b']} h{r['h']} sq{r['sq']} "
            f"sk{r['sk']} d{r['d']} lens{r['lens']} dropout{r['dropout']} "
            f"causal={r['causal']} max_abs_err {errs}")
        for n in r.get("ms", {}):
            bms, by = r["bound"][n]
            ms = r["ms"][n]
            peak = {"bfloat16": "bf16 tensor-core",
                    "float16": "f16 tensor-core"}.get(r["dtype"], "3xTF32")
            cores = r.get("bound_cores", {}).get(n)
            log(f"{tag}:   {n:4s} ms {ms:.4f} (unheld {unheld(ms):.4f}) "
                f"plain_ms {r['plain_ms'][n]:.4f} library_ms "
                f"{r['library_ms'][n]:.4f} (unheld "
                f"{unheld(r['library_ms'][n]):.4f}) bound_ms {bms:.4f} ({by}, "
                f"{peak} peak): {r['flops'][n] / ms / 1e9:.1f} TFLOP/s, "
                f"{bms / ms:.3f} of the bound"
                + ("" if cores is None else
                   f"; on the CUDA cores bound_ms {cores[0]:.4f} "
                   f"({cores[1]}), {cores[0] / ms:.3f} of it"))


def phase_flash_noncausal(torch, flush):
    """ERNIE's attention: the three flash kernels with causal=False at
    B=32 H=12 S=512 D=64 (no kv_lens, and kv_lens < S), bf16 timed next to
    SDPA with is_causal=False, f32 checked."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for dtype in ("bfloat16", "float32"):
        rows.append(_flash_train_case(torch, 32, 12, 512, 512, 64, dtype,
                                      None, 0.0, gen, flush,
                                      timed=dtype == "bfloat16",
                                      causal=False))
        lens = [512 - 37 * (i % 7) for i in range(32)]
        rows.append(_flash_train_case(torch, 32, 12, 512, 512, 64, dtype,
                                      lens, 0.0, gen, flush, timed=False,
                                      causal=False))
    # the f32 forward (3xTF32) at every head dim, non-causal, with dropout
    # 0.1 and without, kv_lens 0 and mid-tile
    for d in (64, 128, 256):
        for dropout in (0.0, 0.1):
            rows.append(_flash_train_case(torch, 3, 2, 160, 300, d,
                                          "float32", [300, 0, 129], dropout,
                                          gen, flush, timed=False,
                                          causal=False))
    _log_flash_rows("flash-noncausal", rows)
    return rows


# DETR's attention shapes at batch 8 (d_model 256 over 8 heads: B*H = 64,
# head_dim 32): the encoder over the 25 x 42 = 1050 tokens of an 800 x
# 1333 image, the decoder's 100 queries against themselves and against
# the encoder's tokens
DETR_ATTENTION = (("encoder", 1050, 1050), ("decoder-self", 100, 100),
                  ("decoder-cross", 100, 1050))


def _f64_attention(torch, q, k, v):
    """Non-causal attention over [BH, S, D] in float64, no mask."""
    s = torch.matmul(q.double(), k.double().transpose(1, 2))
    p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
    return torch.matmul(p, v.double())


def phase_flash_d32(torch, flush):
    """#1's f32 forward at head_dim 32 against its plain twin at DETR's
    three attention shapes (B=8, H=8, non-causal), key lengths none, 0
    (every other batch) and mid-tile, dropout 0 and 0.1; against a float64
    product at the encoder's shape beside the same case at D=64, both
    within the f32 bar; timed at the encoder's shape beside SDPA in f32
    and the 3xTF32 bound."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    gen = torch.Generator(device="cuda").manual_seed(32)
    rows = []
    for _, sq, sk in DETR_ATTENTION:
        for lens in (None, [0, sk] * 4,
                     [min(sk, 97 + 131 * i) for i in range(8)]):
            for dropout in (0.0, 0.1):
                rows.append(_flash_case(
                    torch, 8, 8, sq, sk, 32, "float32", lens, gen, flush,
                    timed=sk == sq == 1050 and lens is None and not dropout,
                    dropout=dropout, causal=False))
    _log_fwd_rows("flash-d32", rows)
    f64 = {}
    for d in (32, 64):
        q, k, v = (torch.randn(64, 1050, d, generator=gen, device="cuda")
                   for _ in range(3))
        want = _f64_attention(torch, q, k, v)
        scale = want.abs().clamp(min=1.0)
        o, _ = kfa.flash_attention_fwd(q, k, v)
        po, _ = kfa.flash_attention_fwd_plain(q, k, v)
        f64[d] = ((o.double() - want).abs() / scale).max().item()
        twin = ((po.double() - want).abs() / scale).max().item()
        log(f"flash-d32: f32 b8 h8 sq1050 sk1050 d{d}: kernel from float64 "
            f"{f64[d]:.3e}, the twin {twin:.3e}, of max(1, |o|)")
        check(f64[d] <= TOL["float32"],
              f"flash-d32: the f32 kernel at D={d} is {f64[d]} from float64"
              f" > {TOL['float32']}")
    check(f64[32] <= F32_D32_F64_TOL,
          f"flash-d32: the f32 kernel at D=32 is {f64[32]} from float64, "
          f"over D=64's reading at this shape ({F32_D32_F64_TOL})")
    timed = next(r for r in rows if "ms" in r)
    return dict(rows=rows, timed=timed, f64=f64, bwd=_flash_d32_bwd(
        torch, flush, gen))


def _flash_d32_bwd(torch, flush, gen):
    """#3/#4's f32 kernels at head_dim 32 against their twins at DETR's
    three attention shapes at detr-train's batch (B=4, H=8, non-causal),
    key lengths none, 0 (every other batch) and mid-tile, dropout 0 and
    0.1, each with the forward (the f32 bar; a second backward bit for
    bit); timed at each shape without key lengths, with dropout 0.1 (what
    detr-train runs) and 0, beside the twin, SDPA's f32 backward at the
    same dropout and the bounds (3xTF32, the CUDA cores'); then dq, dk and
    dv from a float64 backward of the same inputs (_bwd_f64_readings)."""
    rows = []
    for _, sq, sk in DETR_ATTENTION:
        for lens in (None, [0, sk] * 2,
                     [min(sk, 97 + 131 * i) for i in range(4)]):
            for dropout in (0.0, 0.1):
                rows.append(_flash_train_case(
                    torch, 4, 8, sq, sk, 32, "float32", lens, dropout, gen,
                    flush, timed=lens is None, causal=False))
    _log_flash_rows("flash-d32 bwd", rows)
    timed = {(name, r["dropout"]): r for name, sq, sk in DETR_ATTENTION
             for r in rows if "ms" in r and (r["sq"], r["sk"]) == (sq, sk)}
    for (name, dropout), r in timed.items():
        pair, sdpa = r["ms"]["dq"] + r["ms"]["dkv"], r["library_ms"]["dq"]
        log(f"flash-d32 bwd: {name} dropout {dropout}: #3 + #4 take "
            f"{pair:.4f} ms, {pair / sdpa:.3f} x SDPA's whole f32 backward "
            f"at that dropout ({sdpa:.4f} ms, TF32 off)")
    return dict(rows=rows, timed=timed, f64=_bwd_f64_readings(torch))


# (tag, b, h, s, d, causal, dropout, input seed) of the f32 backward's
# float64 readings
BWD_F64_CASES = (("detr-encoder", 4, 8, 1050, 32, False, 0.0, 64),
                 ("detr-encoder", 4, 8, 1050, 32, False, 0.1, 65),
                 ("gpt-f32", 8, 16, 1024, 64, True, 0.0, 66))


def _f64_case(torch, b, h, s, d, causal, dropout, seed):
    """One BWD_F64_CASES input, made from its own seed: ((q, k, v, o, dO,
    lse, seed tensor, causal, dropout), the float64 backward (dq, dk, dv))
    with o and lse from the f32 forward kernel."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   for _ in range(4))
    seed_t = torch.tensor([4321], dtype=torch.int32, device="cuda")
    o, lse = kfa.flash_attention_fwd(q, k, v, None, seed_t, causal, None,
                                     dropout)
    keep = (kfa.dropout_keep(seed_t, b * h, s, s, dropout, "cuda")
            if dropout else None)
    want = _f64_bwd(torch, q, k, v, o, lse, do, causal, keep, dropout)
    return (q, k, v, o, do, lse, seed_t, causal, dropout), want


def _bwd_f64_readings(torch):
    """dq, dk and dv of #3/#4 f32 and of their twins from a float64
    backward of the same inputs, of max(1, |g|), at BWD_F64_CASES (DETR's
    encoder, dropout 0 and 0.1; GPT's f32 shape, 8 x 16 x 1024, D = 64,
    causal): the kernels' within the f32 bar and within the CUDA-core
    kernels' reading on the same inputs (F32_BWD_F64_TOL)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    out = {}
    for tag, b, h, s, d, causal, dropout, seed in BWD_F64_CASES:
        (q, k, v, o, do, lse, seed_t, _, _), want = _f64_case(
            torch, b, h, s, d, causal, dropout, seed)
        rest = (None, seed_t, causal, None, dropout)
        names = ("dq", "dk", "dv")
        got = dict(zip(names, _from_f64(
            kfa.flash_attention_bwd(q, k, v, o, lse, do, *rest), want)))
        twin = dict(zip(names, _from_f64(
            kfa.flash_attention_bwd_plain(q, k, v, o, lse, do, *rest), want)))
        bar = F32_BWD_F64_TOL[(tag, dropout)]
        log(f"flash-d32 bwd: f32 {tag} b{b} h{h} s{s} d{d} causal={causal} "
            f"dropout {dropout}: from a float64 backward, of max(1, |g|): "
            + ", ".join(f"{n} kernel {got[n]:.3e} twin {twin[n]:.3e}"
                        for n in names)
            + f"; the CUDA-core kernels' reading {bar:.3e}")
        worst = max(got.values())
        check(worst <= TOL["float32"] and worst <= bar,
              f"flash-d32 bwd: {tag} dropout {dropout}: the f32 backward is "
              f"{worst} from float64, over the CUDA-core kernels' {bar}")
        out[(tag, dropout)] = dict(kernel=got, twin=twin)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    return out


def _bwd_pair(torch, dq_fn, dkv_fn, q, k, v, o, do, lse, seed, causal,
              dropout):
    """(dq, dk/dv) callables over the C entries of a built
    flash_attention_bwd library, with the wrapper's arguments."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    bh, sq, d = q.shape
    sk = k.shape[1]
    seed_ptr, thresh, keep = kfa._drop_args(seed, dropout)
    stream = torch.cuda.current_stream().cuda_stream
    # no dense mask: a source from before the mask's arguments reads the
    # first of them (a null pointer) as its stream, the default one, where
    # the calls run anyway
    common = (bh, sq, sk, d, int(causal), 1.0 / math.sqrt(d), thresh, keep,
              int(q.dtype == torch.bfloat16), *kfa._mask_args(None), stream)

    def run_dq():
        dq = torch.empty_like(q)
        delta = torch.empty(bh, sq, dtype=torch.float32, device="cuda")
        check(dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), None, seed_ptr,
                    dq.data_ptr(), delta.data_ptr(), *common) == 0,
              "compare: dq launch failed")
        return dq, delta

    def run_dkv(delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check(dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), None, seed_ptr,
                     dk.data_ptr(), dv.data_ptr(), *common) == 0,
              "compare: dk/dv launch failed")
        return dk, dv
    return run_dq, run_dkv


def _build_compare(sources, tag):
    """[(source, ctypes.CDLL)]: each given source (another version of one
    of the package's kernel sources: its parent, a variant) built with the
    package's nvcc flags, all at once, and loaded; each instantiation's
    registers and spill stores printed. A source's own directory comes
    first on the include path, then the package's csrc/, so a parent's
    source builds with the parent's headers beside it."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(_build.BUILD_DIR, "compare")
    os.makedirs(out, exist_ok=True)
    started = [(src, os.path.join(out, f"lib{tag}{i}.so")) for i, src in
               enumerate(sources)]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                               "-v", "-I", _build.CSRC_DIR, "-o", lib, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, lib in started]
    built = []
    for (src, lib), proc in zip(started, procs):
        text = proc.communicate()[0]
        check(proc.returncode == 0, f"compare: nvcc failed for {src}:\n{text}")
        for kern, nreg, spill in _instantiations(text):
            log(f"compare: {src}: {kern}: {nreg} registers, {spill} bytes "
                "spill stores")
        built.append((src, ctypes.CDLL(lib)))
    return built


def _in_turns(torch, theirs, ours, flush):
    """Held ms of two callables in turns (theirs, ours, ours, theirs):
    ({"theirs": [ms, ms], "ours": [ms, ms]}, mean theirs, mean ours)."""
    ms = {"theirs": [], "ours": []}
    for who, fn in (("theirs", theirs), ("ours", ours), ("ours", ours),
                    ("theirs", theirs)):
        ms[who].append(time_ms(torch, fn, flush=flush))
    return ms, sum(ms["theirs"]) / 2, sum(ms["ours"]) / 2


# back-to-back m16n8k8 TF32 products from registers, eight independent
# accumulators a warp (the rate mma.sync reaches with no load and no other
# instruction in the way), and cvt.rna.tf32.f32 over an array
_HMMA_RATE_SRC = r"""
#include <stdint.h>
__global__ void hmma_rate_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int hmma_rate(float* out, int blocks, int iters, void* stream) {
  hmma_rate_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
__global__ void cvt_rna_kernel(const float* x, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(out[i]) : "f"(x[i]));
}
extern "C" int cvt_rna(const float* x, uint32_t* out, int n, void* stream) {
  cvt_rna_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, out,
                                                                    n);
  return (int)cudaGetLastError();
}
"""


def tf32_checks(torch):
    """The TF32 facts the f32 forward rests on: ``cvt.rna.tf32.f32`` gives
    exactly the integer rounding ``tc::to_tf32`` does ((bits + 0x1000) &
    ~0x1fff) on normal values of every exponent, ties and signed zeros
    (else the run fails); and the TF32 rate of back-to-back mma.sync
    m16n8k8 products (no loads) at 2 and at 8 blocks of 4 warps an SM,
    what the forward's products could reach on mma.sync."""
    import numpy as np
    from paddle_tpu_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f"tf32_checks.{x}")
                for x in ("cu", "so"))
    with open(src, "w") as f:
        f.write(_HMMA_RATE_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    cdll = ctypes.CDLL(lib)
    stream = torch.cuda.current_stream().cuda_stream
    cvt = cdll.cvt_rna
    cvt.restype = ctypes.c_int
    cvt.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p]
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(1 << 20) * np.exp2(rng.integers(-100, 100,
                                                            1 << 20)),
        [1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 0.0, -0.0,
         3.4e38]]).astype(np.float32)
    xt = torch.from_numpy(x).cuda()
    got = torch.empty(len(x), dtype=torch.int32, device="cuda")
    check(cvt(xt.data_ptr(), got.data_ptr(), len(x), stream) == 0, "cvt_rna")
    bits = x.view(np.uint32).astype(np.uint64)
    want = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
    differ = int((got.cpu().numpy().view(np.uint32) != want).sum())
    check(differ == 0, f"tf32: cvt.rna.tf32.f32 differs from the integer "
          f"rounding on {differ} of {len(x)} values")
    log(f"compare-fwd: cvt.rna.tf32.f32 == (bits + 0x1000) & ~0x1fff on all "
        f"{len(x)} values (normals of exponents -100..100, ties, zeros)")
    fn = cdll.hmma_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    iters = 4096
    for per_sm in (2, 8):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 128, device="cuda")
        run = lambda: check(fn(  # noqa: E731
            out.data_ptr(), blocks, iters,
            torch.cuda.current_stream().cuda_stream) == 0, "hmma_rate")
        ms = time_ms(torch, run)
        rate = blocks * 4 * iters * 8 * 2048 / ms / 1e9
        log(f"compare-fwd: mma.sync m16n8k8 TF32 back to back, {per_sm} "
            f"blocks of 4 warps an SM: {rate:.1f} TFLOP/s = "
            f"{rate * 1e12 / TF32_FLOPS:.3f} of the 495 TFLOP/s TF32 peak")


def compare_fwd(torch, sources):
    """``--compare-fwd SRC...``: build each given flash_attention_fwd.cu
    (its C entry has the package's signature) with the package's flags,
    hold its forward to the package's (o at the dtype's bar, lse within
    1e-3) and time both in turns (theirs, ours, ours, theirs; held) at
    GPT's training shape with and without dropout 0.1 (bf16, causal),
    ERNIE's (bf16, non-causal), the f32 serving prefill (causal, key
    length 921 of 1024), GPT's shape in f32 with and without dropout 0.1,
    f32 at D=128 (B=2 H=16 S=1024, causal) and DETR's encoder (B=8 H=8
    S=1050 D=32, non-causal; a source without D=32 is skipped there),
    beside SDPA held and
    unheld, with TFLOP/s of the visible work and share of the bound
    (fwd_bound: f32 in 3xTF32), and for f32 the TF32 rate the kernel's
    HMMAs ran at, after the TF32 checks (tf32_checks)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    entries = []
    for src, cdll in _build_compare(sources, "fwd"):
        fn = cdll.flash_attention_fwd
        fn.restype, fn.argtypes = ctypes.c_int, kfa._FWD_ARGTYPES
        entries.append((src, fn))
    tf32_checks(torch)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, b, h, s, d, causal, dropout, dtype, lens in (
            ("gpt", 8, 16, 1024, 64, True, 0.1, "bfloat16", None),
            ("gpt-nodrop", 8, 16, 1024, 64, True, 0.0, "bfloat16", None),
            ("ernie", 32, 12, 512, 64, False, 0.0, "bfloat16", None),
            ("prefill-f32", 1, 16, 1024, 64, True, 0.0, "float32", [921]),
            ("gpt-f32", 8, 16, 1024, 64, True, 0.1, "float32", None),
            ("gpt-f32-nodrop", 8, 16, 1024, 64, True, 0.0, "float32", None),
            ("f32-d128", 2, 16, 1024, 128, True, 0.0, "float32", None),
            ("detr-enc-f32", 8, 8, 1050, 32, False, 0.0, "float32", None)):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(b * h, s, d, generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        lens_t = None if lens is None else torch.tensor(
            [x for x in lens for _ in range(h)], dtype=torch.int32,
            device="cuda")
        seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
        rest = (lens_t, seed, causal, None, dropout)
        o, lse = kfa.flash_attention_fwd(q, k, v, *rest)
        ours = lambda: kfa.flash_attention_fwd(q, k, v, *rest)  # noqa: E731
        pairs = h * visible_pairs(b, s, s, lens, causal)
        esz = q.element_size()
        flops = 4 * d * pairs
        bms, by = fwd_bound(dtype, 4 * b * h * s * d * esz + b * h * s * 4,
                            pairs, d)
        seed_ptr, thresh, keep = kfa._drop_args(seed, dropout)
        for src, fn in entries:
            def launch():
                to = torch.empty_like(q)
                tl = torch.empty(b * h, s, dtype=torch.float32,
                                 device="cuda")
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         None if lens_t is None else lens_t.data_ptr(),
                         to.data_ptr(), tl.data_ptr(), b * h, s, s, d,
                         int(causal), 1.0 / math.sqrt(d), seed_ptr, thresh,
                         keep, int(dtype == "bfloat16"),
                         # no dense mask (see _bwd_pair)
                         *kfa._mask_args(None),
                         torch.cuda.current_stream().cuda_stream)
                return err, to, tl

            def theirs():
                err, to, tl = launch()
                check(err == 0, "compare: forward launch failed")
                return to, tl
            err, to, tl = launch()
            if err and d == 32:
                log(f"compare-fwd {tag}: {src} has no D=32 instantiation; "
                    "skipped")
                continue
            check(err == 0, "compare: forward launch failed")
            torch.cuda.synchronize()
            e, le = _err(to, o)[0], _err(tl, lse)[0]
            check(e <= TOL[dtype] and le <= 1e-3, f"compare {tag}: {src} o "
                  f"differs from the package's by {e}, lse by {le}")
            ms, t_ms, o_ms = _in_turns(torch, theirs, ours, flush)
            # f32: the TF32 rate the tensor cores ran at (every HMMA the
            # kernel issues, masked products and all), against 495 TFLOP/s
            executed = ""
            if dtype == "float32":
                rate = 2048 * f32_fwd_hmmas(
                    [s if lens is None else lens[i // h]
                     for i in range(b * h)], s, s, d, causal) / o_ms / 1e9
                executed = (f"; ours executed {rate:.1f} TF32 TFLOP/s = "
                            f"{rate * 1e12 / TF32_FLOPS:.3f} of the TF32 "
                            "peak")
            log(f"compare-fwd {tag}: {src}: held ms in turns (theirs, ours, "
                f"ours, theirs): theirs {ms['theirs'][0]:.4f} "
                f"{ms['theirs'][1]:.4f}, ours {ms['ours'][0]:.4f} "
                f"{ms['ours'][1]:.4f}; theirs / ours = {t_ms / o_ms:.2f}; "
                f"ours {flops / o_ms / 1e9:.1f} TFLOP/s, {bms / o_ms:.3f} "
                f"of the bound {bms:.4f} ms ({by}); theirs "
                f"{flops / t_ms / 1e9:.1f} TFLOP/s; o err {e:.2e}, lse "
                f"err {le:.2e}{executed}")
        qt, kt, vt = (x.view(b, h, s, d) for x in (q, k, v))
        mask = None
        if lens is not None:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] < lens[0]))[None, None]
        lib = time_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=mask, dropout_p=dropout,
            is_causal=causal and mask is None), flush=flush)
        log(f"compare-fwd {tag}: SDPA held {lib:.4f} ms, unheld "
            f"{unheld(lib):.4f} ms")


def compare_decode(torch, sources):
    """``--compare-decode SRC...``: build each given flash_decode.cu with
    the package's flags, hold it to the package's kernel (the dtype's bar)
    and time both in turns (theirs, ours, ours, theirs; held) at GPT's f32
    generate shape (B=8 H=16 D=64) and Llama-2-7B's bf16 one (B=4 H=32
    D=128), every row at 576 keys, beside SDPA held and unheld. A source
    of the earlier two-launch design (a decode_combine_kernel; C entry
    with part_acc, part_ml) is given its scratch and split (4 x 132
    blocks, chunks of 2048 / D keys); any other, the package's. Then the package's kernel at other targets
    of blocks a call (``_DECODE_BLOCKS``; 1 gives one block a row)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    entries = []
    for src, cdll in _build_compare(sources, "decode"):
        fn = cdll.flash_decode
        fn.restype, fn.argtypes = ctypes.c_int, kfa._DECODE_ARGTYPES
        with open(src) as f:  # the two-launch source has a combine kernel
            entries.append((src, fn, "decode_combine_kernel" in f.read()))
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(11)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, b, h, d, dtype in (("gpt-f32", 8, 16, 64, "float32"),
                                ("llama-bf16", 4, 32, 128, "bfloat16")):
        dt, s = getattr(torch, dtype), 576
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        out = kfa.flash_decode(q, k, v, lens)
        ours = lambda: kfa.flash_decode(q, k, v, lens)  # noqa: E731
        for src, fn, two_launch in entries:
            if two_launch:
                unit = 2048 // d
                want = max(1, -(-528 // (b * h)))
                chunk = -(-max(1, -(-s // want)) // unit) * unit
                splits = -(-s // chunk)
                p0 = torch.empty(b * h * splits * d, dtype=torch.float32,
                                 device="cuda")
                p1 = torch.empty(b * h * splits * 2, dtype=torch.float32,
                                 device="cuda")
            else:
                splits, chunk = kfa.decode_split(b, h, s)
                p0 = torch.empty(b * h * splits * (d + 2),
                                 dtype=torch.float32, device="cuda")
                p1 = torch.zeros(b * h, dtype=torch.int32, device="cuda")

            def theirs():
                to = torch.empty_like(q)
                check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lens.data_ptr(), to.data_ptr(), p0.data_ptr(),
                         p1.data_ptr(), b, h, s, d, splits, chunk,
                         q.stride(0), q.stride(2), *k.stride()[:3],
                         *v.stride()[:3], int(dtype == "bfloat16"),
                         1.0 / math.sqrt(d),
                         torch.cuda.current_stream().cuda_stream) == 0,
                      "compare: decode launch failed")
                return to
            e = _err(theirs(), out)[0]
            check(e <= TOL[dtype], f"compare {tag}: {src} differs from the "
                  f"package's decode by {e}")
            ms, t_ms, o_ms = _in_turns(torch, theirs, ours, flush)
            log(f"compare-decode {tag}: {src} ({'two launches' if two_launch else 'one launch'}, "
                f"splits {splits} x {chunk}): held ms in turns (theirs, "
                f"ours, ours, theirs): theirs {ms['theirs'][0]:.4f} "
                f"{ms['theirs'][1]:.4f}, ours {ms['ours'][0]:.4f} "
                f"{ms['ours'][1]:.4f}; theirs / ours = {t_ms / o_ms:.2f}; "
                f"err {e:.2e}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(torch, lambda: sdpa(qt, kt, vt), flush=flush)
        log(f"compare-decode {tag}: SDPA held {lib:.4f} ms, unheld "
            f"{unheld(lib):.4f} ms; ours splits {kfa.decode_split(b, h, s)}")
        default = kfa._DECODE_BLOCKS
        try:
            for blocks in (1, 132, 264, 528, 1056):
                kfa._DECODE_BLOCKS = blocks
                got = ours()
                e = _err(got, out)[0]
                check(e <= TOL[dtype], f"compare {tag}: {blocks} blocks: "
                      f"err {e}")
                t = time_ms(torch, ours, flush=flush)
                log(f"compare-decode {tag}: ours aiming at {blocks} blocks "
                    f"(splits, chunk) {kfa.decode_split(b, h, s)}: held "
                    f"{t:.4f} ms, unheld {unheld(t):.4f}; err {e:.2e}")
        finally:
            kfa._DECODE_BLOCKS = default


# the C entry of a paged_flash_decode.cu without scratch (one block per
# slot and kv head, before the split): q, pools, scales, page_table, lens,
# out; b, hkv, g, num_pages, ps, max_pages, d, pool code; sm_scale; stream
_PAGED_UNSPLIT_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]
# phase_decode's timed shapes: (tag, b, hkv, g, dtype)
PAGED_SHAPES = (("f32-b8", 8, 16, 1, "float32"),
                ("bf16-b8", 8, 16, 1, "bfloat16"),
                ("int8-b8", 8, 16, 1, "int8"),
                ("f32-b32", 32, 16, 1, "float32"),
                ("bf16-b32", 32, 16, 1, "bfloat16"),
                ("int8-b32", 32, 16, 1, "int8"),
                ("gqa-f32-b8", 8, 4, 4, "float32"))


def compare_paged(torch, sources):
    """``--compare-paged SRC...``: build each given paged_flash_decode.cu
    with the package's flags, hold it to the package's kernel (the dtype's
    bar) and time both in turns (theirs, ours, ours, theirs; held) at
    phase_decode's timed shapes (hkv16 g1 d64 ps16 mp64 at b8 and b32 in
    f32, bf16 and int8, and GQA b8 hkv4 g4 f32; lens 65..576, the GQA
    case 1..1024, from numpy seed 2), beside the bound. A source whose C
    entry takes no scratch (one block per slot and kv head) is called so;
    any other with the package's split and its own scratch. Then the
    package's kernel with L2 evicted by a read in place of the usual
    write (no dirty lines to write back), with every lens 0, and at other
    targets of blocks a call (``_PAGED_BLOCKS``; 1 gives one chunk a
    slot)."""
    import numpy as np
    kpd = _paged_module()
    entries = []
    for src, cdll in _build_compare(sources, "paged"):
        fn = cdll.paged_flash_decode
        with open(src) as f:
            unsplit = "counters" not in f.read()
        fn.restype = ctypes.c_int
        fn.argtypes = _PAGED_UNSPLIT_ARGTYPES if unsplit else kpd._ARGTYPES
        entries.append((src, fn, unsplit))
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(12)
    d, ps, mp = 64, 16, 64
    for tag, b, hkv, g, dtype in PAGED_SHAPES:
        lens = (rng.integers(1, 1025, b) if g > 1
                else rng.integers(65, 577, b)).tolist()
        q, kp, vp, pt, lens_t, ks, vs = _decode_inputs(
            torch, b, hkv, g, d, ps, mp, dtype, lens, gen)
        ours = lambda: kpd.paged_flash_decode(  # noqa: E731
            q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs)
        out = ours()
        bms, by = bound(_decode_bytes(b, hkv, g, d, lens, kp, pt,
                                      ks is not None),
                        4 * hkv * g * d * int(sum(lens)))
        code = kpd._POOL_CODES[kp.dtype]
        scale_ptrs = (None, None) if ks is None else (ks.data_ptr(),
                                                      vs.data_ptr())
        for src, fn, unsplit in entries:
            splits, ppc = kpd.paged_decode_split(b, hkv, g, mp, ps)
            part = torch.empty(b * hkv * g * splits * (d + 2),
                               dtype=torch.float32, device="cuda")
            counters = torch.zeros(b * hkv * -(-g // 4), dtype=torch.int32,
                                   device="cuda")

            def theirs():
                to = torch.empty_like(out)
                head = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        *scale_ptrs, pt.data_ptr(), lens_t.data_ptr(),
                        to.data_ptr())
                stream = torch.cuda.current_stream().cuda_stream
                if unsplit:
                    err = fn(*head, b, hkv, g, kp.shape[1], ps, mp, d, code,
                             1.0 / math.sqrt(d), stream)
                else:
                    err = fn(*head, part.data_ptr(), counters.data_ptr(), b,
                             hkv, g, kp.shape[1], ps, mp, d, code, splits,
                             ppc, 1.0 / math.sqrt(d), stream)
                check(err == 0, "compare: paged decode launch failed")
                return to
            e = _err(theirs(), out)[0]
            check(e <= TOL[dtype], f"compare {tag}: {src} differs from the "
                  f"package's paged decode by {e}")
            ms, t_ms, o_ms = _in_turns(torch, theirs, ours, flush)
            log(f"compare-paged {tag}: {src} "
                f"({'one block a slot and kv head' if unsplit else 'split'}"
                f"): held ms in turns (theirs, ours, ours, theirs): theirs "
                f"{ms['theirs'][0]:.4f} {ms['theirs'][1]:.4f}, ours "
                f"{ms['ours'][0]:.4f} {ms['ours'][1]:.4f}; theirs / ours = "
                f"{t_ms / o_ms:.2f}; of the bound {bms:.4f} ms ({by}): "
                f"theirs {bms / t_ms:.3f}, ours {bms / o_ms:.3f}; err "
                f"{e:.2e}")
        # what the time holds besides the live pages: the flush's dirty L2
        # lines written back under the kernel's reads (a flush by a read
        # leaves clean ones), and the launch with no key to read
        clean = time_ms(torch, ours, flush=scratch.sum)
        no_keys = torch.zeros_like(lens_t)
        empty = time_ms(torch, lambda: kpd.paged_flash_decode(
            q, kp, vp, pt, no_keys, k_scale=ks, v_scale=vs), flush=flush)
        # a plain read of as many bytes as the live pages, contiguous: what
        # one streaming kernel reaches here
        live = torch.empty(int(_decode_bytes(b, hkv, g, d, lens, kp, pt,
                                             ks is not None)) // 4,
                           dtype=torch.float32, device="cuda")
        read = time_ms(torch, live.sum, flush=flush)
        log(f"compare-paged {tag}: ours with L2 evicted by a read (clean "
            f"lines) held {clean:.4f} ms, {bms / clean:.3f} of the bound; "
            f"with every lens 0 (launch, lens, exit) held {empty:.4f} ms; "
            f"torch.sum over as many contiguous bytes held {read:.4f} ms, "
            f"{bms / read:.3f} of the bound")
        del live
        default = kpd._PAGED_BLOCKS
        try:
            for blocks in (1, 132, 264, 528, 1056):
                kpd._PAGED_BLOCKS = blocks
                e = _err(ours(), out)[0]
                check(e <= TOL[dtype], f"compare {tag}: {blocks} blocks: "
                      f"err {e}")
                t = time_ms(torch, ours, flush=flush)
                log(f"compare-paged {tag}: ours aiming at {blocks} blocks "
                    f"(splits, pages a chunk) "
                    f"{kpd.paged_decode_split(b, hkv, g, mp, ps)}: held "
                    f"{t:.4f} ms, unheld {unheld(t):.4f}, {bms / t:.3f} of "
                    f"the bound; err {e:.2e}")
        finally:
            kpd._PAGED_BLOCKS = default


# (tag, b, h, sq, sk, d, causal, dropout, dtype) of --compare-bwd: GPT's
# and ERNIE's bf16 training shapes; DETR's three attention shapes at
# detr-train's batch, GPT's f32 training shape and GPT-1.3B's in f32
COMPARE_BWD = (
    ("gpt", 8, 16, 1024, 1024, 64, True, 0.1, "bfloat16"),
    ("gpt-nodrop", 8, 16, 1024, 1024, 64, True, 0.0, "bfloat16"),
    ("ernie", 32, 12, 512, 512, 64, False, 0.0, "bfloat16"),
    ("detr-encoder-f32", 4, 8, 1050, 1050, 32, False, 0.1, "float32"),
    ("detr-decoder-self-f32", 4, 8, 100, 100, 32, False, 0.1, "float32"),
    ("detr-decoder-cross-f32", 4, 8, 100, 1050, 32, False, 0.1,
     "float32"),
    ("gpt-f32", 8, 16, 1024, 1024, 64, True, 0.1, "float32"),
    ("gpt-f32-nodrop", 8, 16, 1024, 1024, 64, True, 0.0, "float32"),
    ("gpt-1.3b-f32", 4, 16, 1024, 1024, 128, True, 0.1, "float32"))


def compare_bwd(torch, sources):
    """``--compare-bwd SRC...``: build each given flash_attention_bwd.cu
    (another version of the package's backward source: its parent, a
    variant) with the package's nvcc flags and headers, hold its dq, dk and
    dv to the package's own at the dtype's bar of max(1, |ours|), and time
    both in turns (theirs, ours, ours, theirs; held) at the COMPARE_BWD
    shapes, beside SDPA's backward held and unheld and the bounds (f32:
    3xTF32 and the CUDA cores'); in f32 each side's dq, dk and dv from a
    float64 backward of the same inputs, of max(1, |g|), there and at
    phase flash-d32's BWD_F64_CASES on that phase's inputs (the parent's
    readings there are F32_BWD_F64_TOL)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    entries = []
    for src, cdll in _build_compare(sources, "bwd"):
        fns = (cdll.flash_attention_bwd_dq, cdll.flash_attention_bwd_dkv)
        for fn, types in zip(fns, (kfa._DQ_ARGTYPES, kfa._DKV_ARGTYPES)):
            fn.restype, fn.argtypes = ctypes.c_int, types
        entries.append((src, fns))
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, b, h, sq, sk, d, causal, dropout, dtype in COMPARE_BWD:
        dt = getattr(torch, dtype)
        q, do = (torch.randn(b * h, sq, d, generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn(b * h, sk, d, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
        rest = (None, seed, causal, None, dropout)
        o, lse = kfa.flash_attention_fwd(q, k, v, *rest)
        dq, delta = kfa.flash_attention_bwd_dq(q, k, v, o, do, lse, *rest)
        dk, dv = kfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *rest)
        ours = {"dq": lambda: kfa.flash_attention_bwd_dq(
                    q, k, v, o, do, lse, *rest),
                "dkv": lambda: kfa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, *rest)}
        want = None
        if dtype == "float32":
            keep = (kfa.dropout_keep(seed, b * h, sq, sk, dropout, "cuda")
                    if dropout else None)
            want = _f64_bwd(torch, q, k, v, o, lse, do, causal, keep,
                            dropout)
            del keep
            e64 = _from_f64((dq, dk, dv), want)
            log(f"compare {tag}: ours from a float64 backward, of max(1, "
                f"|g|): dq {e64[0]:.3e}, dk {e64[1]:.3e}, dv {e64[2]:.3e}")
        for src, (dq_fn, dkv_fn) in entries:
            run_dq, run_dkv = _bwd_pair(torch, dq_fn, dkv_fn, q, k, v, o, do,
                                        lse, seed, causal, dropout)
            (tq, tdelta), (tk, tv) = run_dq(), run_dkv(delta)
            for n, x, w in (("dq", tq, dq), ("dk", tk, dk), ("dv", tv, dv)):
                e = _err(x, w)[1]
                check(e <= TOL[dtype], f"compare {tag}: {src} {n} "
                      f"differs from the package's by {e} of max(1, |ours|)")
            if want is not None:
                e64 = _from_f64((tq, tk, tv), want)
                log(f"compare {tag}: {src} from a float64 backward, of "
                    f"max(1, |g|): dq {e64[0]:.3e}, dk {e64[1]:.3e}, dv "
                    f"{e64[2]:.3e}")
            del tq, tdelta, tk, tv
            theirs = {"dq": run_dq, "dkv": lambda: run_dkv(delta)}
            ms = {}
            for who, fns in (("theirs", theirs), ("ours", ours),
                             ("ours", ours), ("theirs", theirs)):
                for n, f in fns.items():
                    ms.setdefault((who, n), []).append(
                        time_ms(torch, f, flush=flush))
            mean = {key: sum(v_) / len(v_) for key, v_ in ms.items()}
            pair = {who: mean[(who, "dq")] + mean[(who, "dkv")]
                    for who in ("theirs", "ours")}
            runs = {key: " ".join(f"{x:.4f}" for x in v_)
                    for key, v_ in ms.items()}
            log(f"compare {tag}: {src}: held ms in turns (theirs, ours, "
                f"ours, theirs): dq theirs {runs[('theirs', 'dq')]}, ours "
                f"{runs[('ours', 'dq')]}; dkv theirs {runs[('theirs', 'dkv')]}"
                f", ours {runs[('ours', 'dkv')]}; pair theirs "
                f"{pair['theirs']:.4f}, ours {pair['ours']:.4f}: theirs / "
                f"ours = {pair['theirs'] / pair['ours']:.2f}")
        del want
        work = flash_work(b, h, sq, sk, d, q.element_size(), None, causal)
        bounds = "; ".join(
            f"{n} bound {flash_bound(dtype, n, *work[n])[0]:.4f} ms "
            f"({flash_bound(dtype, n, *work[n])[1]})"
            + ("" if dtype == "bfloat16" else
               f", on the CUDA cores {bound(*work[n], peak=F32_FLOPS)[0]:.4f}")
            for n in ("dq", "dkv"))
        qt, kt, vt = (x.view(b, h, -1, d).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = sdpa(qt, kt, vt, is_causal=causal, dropout_p=dropout)
        lib = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do.view(b, h, sq, d), retain_graph=True),
            flush=flush)
        log(f"compare {tag}: SDPA's backward (dq, dk, dv in one call) held "
            f"{lib:.4f} ms, unheld {unheld(lib):.4f} ms; {bounds}")
        del lib_out, qt, kt, vt, q, k, v, do, o, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    # each side at phase flash-d32's float64 readings, on its inputs: what
    # F32_BWD_F64_TOL holds the package's kernels to
    for tag, b, h, s, d, causal, dropout, seed in BWD_F64_CASES:
        (q, k, v, o, do, lse, seed_t, _, _), want = _f64_case(
            torch, b, h, s, d, causal, dropout, seed)
        rest = (None, seed_t, causal, None, dropout)
        e64 = _from_f64(kfa.flash_attention_bwd(q, k, v, o, lse, do, *rest),
                        want)
        log(f"compare f64 {tag} dropout {dropout}: ours dq {e64[0]:.3e}, dk "
            f"{e64[1]:.3e}, dv {e64[2]:.3e}")
        for src, (dq_fn, dkv_fn) in entries:
            run_dq, run_dkv = _bwd_pair(torch, dq_fn, dkv_fn, q, k, v, o, do,
                                        lse, seed_t, causal, dropout)
            tq, tdelta = run_dq()
            e64 = _from_f64((tq, *run_dkv(tdelta)), want)
            log(f"compare f64 {tag} dropout {dropout}: {src} dq "
                f"{e64[0]:.3e}, dk {e64[1]:.3e}, dv {e64[2]:.3e}")
        del q, k, v, o, do, lse, want
        torch.cuda.empty_cache()


def _adamw_case(torch, n_or_shape, decoupled, gen, flush, timed,
                offset=0):
    from paddle_tpu_torch.ops.kernels import fused_adamw as ka
    shape = (n_or_shape,) if isinstance(n_or_shape, int) else n_or_shape
    n = math.prod(shape)
    mk = lambda: torch.randn(n + offset, generator=gen,  # noqa: E731
                             device="cuda")[offset:].view(shape)
    p, m, g = mk(), mk() * 0.1, mk()
    v = mk().abs() * 0.01
    hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=decoupled)
    step = (1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3)  # lr, bc1, bc2 at step 3
    # the device array the kernel reads them from
    step_t = ka.step_scalars(*step, device="cuda")
    kern = [x.clone() if not offset else x for x in (p, m, v)]
    twin = [x.clone() for x in (p, m, v)]
    # one leaf: the multi-leaf wrapper over a list of one
    table = ka.fused_adamw_multi_update(*([x] for x in kern), [g], step_t,
                                        weight_decays=[0.01], **hp)
    ka.adamw_update_plain(*twin, g, *step, weight_decay=0.01, **hp)
    torch.cuda.synchronize()
    err = max(_err(a, b)[0] for a, b in zip(kern, twin))
    check(math.isfinite(err) and err <= ADAMW_TOL,
          f"adamw {shape} decoupled={decoupled} offset={offset}: "
          f"max_abs_err {err} > {ADAMW_TOL}")
    row = dict(shape=shape, decoupled=decoupled, offset=offset,
               max_abs_err=err)
    if timed:
        row["ms"] = time_ms(torch, lambda: ka.fused_adamw_multi_update(
            *([x] for x in kern), [g], step_t, weight_decays=[0.01],
            table=table, **hp), flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: ka.adamw_update_plain(
            *twin, g, *step, weight_decay=0.01, **hp), flush=flush)
        lp = torch.nn.Parameter(p.clone())
        lp.grad = g
        lib = torch.optim.AdamW([lp], lr=1e-4, weight_decay=0.01,
                                fused=True)
        row["library_ms"] = time_ms(torch, lib.step, flush=flush)
        # read p, m, v, g once and write p, m, v once: 28 bytes a value
        row["bound_ms"], row["bound_by"] = bound(28 * n, 15 * n)
    return row


def _leaf_shapes(torch, build):
    """(name, shape) of every trainable parameter of the model ``build()``
    makes; the model is dropped before this returns."""
    model = build()
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()
              if p.requires_grad]
    del model
    torch.cuda.empty_cache()
    return shapes


def _no_decay(name):
    """Biases and norm weights: the leaves an apply_decay_param_fun
    usually excludes from weight decay."""
    return name.endswith("bias") or "norm" in name or ".ln" in name


def _parent_clip(torch, gs, clip_norm):
    """The parent's ClipGradByGlobalNorm.apply, for its route's time: the
    norm from a sum of squares a leaf, then a scaled copy of every
    gradient."""
    total = torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in gs))
    coef = torch.clamp(clip_norm / total.clamp_min(1e-6), max=1.0)
    return [(x * coef).to(x.dtype) for x in gs]


def _adamw_set_case(torch, tag, shapes, gen, flush, *, decoupled=True,
                    wd=0.01, exclude=False, clip=None, offsets=None,
                    timed=True):
    """The multi-leaf kernel (#10) over one leaf set of ``shapes``: p, m, v,
    g drawn on the card (each leaf its own buffer; ``offsets`` starts a
    leaf's four arrays that many values into theirs, off a 16-byte
    boundary), lr, bc1, bc2 of step 3. ``exclude``: biases and norm weights
    take weight decay 0; ``clip``: the global-norm clip's coefficient at
    that clip_norm (ClipGradByGlobalNorm.coefficient) scales every
    gradient. Held to the multi-leaf twin at ADAMW_TOL, a second launch
    from the same inputs bit for bit, and ceil(leaves / MAX_LEAVES)
    launches. ``timed``: held ms of the kernel, the twin, the route (the
    clip's coefficient, then the kernel), the parent's route (the parent's
    clip, ``_parent_clip``, then #10 on each leaf of at least MIN_SIZE
    values alone and the plain update on the others) and torch.optim.AdamW(fused=True) over
    the same leaves, beside the bound (28 bytes a value)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import fused_adamw as ka
    names = [n for n, _ in shapes]
    offsets = offsets or [0] * len(shapes)
    total = sum(math.prod(s) for _, s in shapes)

    def mk(scale=1.0, absolute=False):
        out = []
        for (_, s), off in zip(shapes, offsets):
            x = torch.randn(math.prod(s) + off, generator=gen,
                            device="cuda")[off:].view(s)
            x = x.abs() if absolute else x
            out.append(x.mul_(scale) if scale != 1.0 else x)
        return out

    p0, m0, v0, g = mk(), mk(0.1), mk(0.01, absolute=True), mk()
    wds = [0.0 if exclude and _no_decay(n) else wd for n in names]
    hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=decoupled,
              weight_decays=wds)
    step = (1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3)
    step_t = ka.step_scalars(*step, device="cuda")
    cl = None if clip is None else ClipGradByGlobalNorm(clip)
    scale = None if cl is None else cl.coefficient(g)

    def clones():
        return [[x.clone() if not off else
                 torch.empty(x.numel() + off, device="cuda")[off:]
                 .view(x.shape).copy_(x) for x, off in zip(xs, offsets)]
                for xs in (p0, m0, v0)]

    kern = clones()
    n0, l0 = (ka.fused_adamw_multi_update.launches,
              ka.fused_adamw_multi_update.leaves)
    table = ka.fused_adamw_multi_update(*kern, g, step_t, scale=scale, **hp)
    want_launches = -(-len(shapes) // ka.MAX_LEAVES)
    check((ka.fused_adamw_multi_update.launches - n0,
           ka.fused_adamw_multi_update.leaves - l0)
          == (want_launches, len(shapes)),
          f"adamw {tag}: {ka.fused_adamw_multi_update.launches - n0} "
          f"launches over {ka.fused_adamw_multi_update.leaves - l0} leaves, "
          f"want {want_launches} over {len(shapes)}")
    twin = clones()
    ka.adamw_multi_update_plain(*twin, g, *step, scale=scale, **hp)
    torch.cuda.synchronize()
    # of max(1, |twin|): under a clip's coefficient (~5e-6 here) the
    # scaled gradient leaves v at its random start, and where that is near
    # 0 a step reaches O(1000), whose ulp alone passes 1e-6 absolute (the
    # twin divides by bc1 and bc2 as PyTorch does, by a reciprocal)
    errs = [_err(a, b) for xs, ys in zip(kern, twin) for a, b in zip(xs, ys)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    top = max(y.abs().max().item() for y in twin[0])
    check(math.isfinite(err) and rel <= ADAMW_TOL,
          f"adamw {tag}: {rel} of max(1, |twin|) > {ADAMW_TOL} (max_abs_err "
          f"{err}, max |p| {top})")
    del twin
    again = clones()
    ka.fused_adamw_multi_update(*again, g, step_t, scale=scale, **hp)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for xs, ys in zip(kern, again)
               for a, b in zip(xs, ys))
    check(same, f"adamw {tag}: a second launch from the same inputs "
          "differs")
    del again
    row = dict(tag=tag, leaves=len(shapes), values=total,
               launches_per_step=want_launches, exclude=exclude, clip=clip,
               max_abs_err=err, max_rel_err=rel, max_p=top,
               small_leaves=sum(math.prod(s) < ka.MIN_SIZE
                                for _, s in shapes))
    if timed:
        kp, km, kv = kern
        run = lambda: ka.fused_adamw_multi_update(  # noqa: E731
            kp, km, kv, g, step_t, scale=scale, table=table, **hp)
        row["ms"] = time_ms(torch, run, flush=flush)
        # the twin and the parent's route issue ~19 launches a small leaf:
        # more than the launch queue holds, so unheld (host-bound) times
        row["plain_ms"] = time_ms(torch, lambda: ka.adamw_multi_update_plain(
            kp, km, kv, g, *step, scale=scale, **hp), flush=flush,
            held=False)

        def route():
            sc = None if cl is None else cl.coefficient(g)
            ka.fused_adamw_multi_update(kp, km, kv, g, step_t, scale=sc,
                                        table=table, **hp)

        one_leaf = {}  # a one-leaf table a leaf, as the parent's did

        def parent():
            gs = g if cl is None else _parent_clip(torch, g, clip)
            for i, (p, m, v, gg, w) in enumerate(zip(kp, km, kv, gs, wds)):
                if p.numel() >= ka.MIN_SIZE:
                    one_leaf[i] = ka.fused_adamw_multi_update(
                        [p], [m], [v], [gg], step_t, beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decays=[w], decoupled=decoupled,
                        table=one_leaf.get(i))
                else:
                    ka.adamw_update_plain(
                        p, m, v, gg, *step, beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decay=w, decoupled=decoupled)
        row["route_ms"] = time_ms(torch, route, flush=flush)
        row["parent_route_ms"] = time_ms(torch, parent, flush=flush,
                                         held=False)
        lib_params = [torch.nn.Parameter(p) for p in kp]
        for lp, gg in zip(lib_params, g):
            lp.grad = gg
        lib = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=wd,
                                fused=True)
        row["library_ms"] = time_ms(torch, lib.step, flush=flush)
        del lib, lib_params
        # read p, m, v, g once and write p, m, v once: 28 bytes a value
        row["bound_ms"], row["bound_by"] = bound(28 * total, 15 * total)
        log(f"adamw {tag}: {len(shapes)} leaves, {total} values "
            f"({row['small_leaves']} below {ka.MIN_SIZE}), "
            f"{want_launches} launch(es): held ms {row['ms']:.4f} (unheld "
            f"{unheld(row['ms']):.4f}), bound {row['bound_ms']:.4f} "
            f"({row['bound_ms'] / row['ms']:.3f} of it); the route "
            f"(coefficient + kernel) held {row['route_ms']:.4f} (unheld "
            f"{unheld(row['route_ms']):.4f}); unheld: the parent's route "
            f"{row['parent_route_ms']:.4f}, the twin {row['plain_ms']:.4f}; "
            f"torch.optim.AdamW(fused=True) {row['library_ms']:.4f} (unheld "
            f"{unheld(row['library_ms']):.4f}); max_abs_err {err:.3e} "
            f"({rel:.3e} of max(1, |twin|), max |p| {top:.3e})")
    else:
        log(f"adamw {tag}: {len(shapes)} leaves, {total} values: "
            f"max_abs_err {err:.3e} ({rel:.3e} of max(1, |twin|), max |p| "
            f"{top:.3e}), a second launch bit for bit")
    return row


def launch_floor(torch):
    """Held ms of the card's smallest kernel, an add_ on one f32 value:
    what a launch costs the device when nothing waits on the host, the
    floor under a toy-sized kernel's time."""
    one = torch.zeros(1, device="cuda")
    return time_ms(torch, lambda: one.add_(1.0))


def phase_adamw(torch, flush):
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for shape in ((1024, 4096), (50304, 1024)):
        for decoupled in (True, False):
            rows.append(_adamw_case(torch, shape, decoupled, gen, flush,
                                    timed=True))
    # GPT-1.3B's largest leaves: the 50304 x 2048 embedding (103 M values)
    # and an MLP matrix
    for shape in ((50304, 2048), (2048, 8192)):
        rows.append(_adamw_case(torch, shape, True, gen, flush, timed=True))
    # a length with a ragged float4 tail, and a view 4 bytes off alignment
    rows.append(_adamw_case(torch, 16411, True, gen, flush, False))
    rows.append(_adamw_case(torch, 20000, True, gen, flush, False, offset=1))
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        log(f"adamw: {r['shape']} decoupled={r['decoupled']} offset="
            f"{r['offset']} max_abs_err {r['max_abs_err']:.3e}{extra}")
    floor = launch_floor(torch)
    log(f"adamw: the launch floor (an add_ on one f32 value) held "
        f"{floor:.4f} ms (unheld {unheld(floor):.4f})")
    # the multi-leaf launch over whole leaf sets: GPT-345M's 388 leaves and
    # DETR-R50's 422, as their training paths give them, each as is and
    # with biases and norm weights kept from decay under a clip scale
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    from paddle_tpu_torch.vision.models import DETR
    sets = {
        "gpt3-345M": _leaf_shapes(torch, lambda: GPTForCausalLM(
            _resolve_config("gpt3-345M"), device="cuda",
            generator=seed(0, device="cuda"))),
        "detr-r50": _leaf_shapes(torch, lambda: DETR(
            device="cuda", generator=seed(0, device="cuda")))}
    check((len(sets["gpt3-345M"]), len(sets["detr-r50"])) == (388, 422),
          f"adamw: leaf sets of {[len(v) for v in sets.values()]} leaves, "
          "want GPT-345M's 388 and DETR-R50's 422")
    multi = {}
    for name, shapes in sets.items():
        for exclude, clip in ((False, None), (True, 0.1)):
            multi[(name, exclude)] = _adamw_set_case(
                torch, f"{name} exclude={exclude} clip={clip}", shapes, gen,
                flush, exclude=exclude, clip=clip)
            torch.cuda.empty_cache()
    # a 1-value leaf, ragged float4 tails, chunk edges, views 1-3 values
    # off a 16-byte boundary; and 1100 leaves: three launches
    edge = [("one", (1,)), ("tail.weight", (16411,)), ("view", (20000,)),
            ("edge", (16384,)), ("bias", (7,)), ("two_chunks", (3, 16389)),
            ("one_off", (1,))]
    for decoupled in (True, False):
        for exclude, clip in ((False, None), (True, 0.1)):
            _adamw_set_case(torch, f"edge decoupled={decoupled} exclude="
                            f"{exclude} clip={clip}", edge, gen, flush,
                            decoupled=decoupled, exclude=exclude, clip=clip,
                            offsets=[0, 0, 1, 0, 2, 0, 3], timed=False)
    many = [(f"l{i}", (1 + (i * 37) % 5000,)) for i in range(1100)]
    _adamw_set_case(torch, "1100 leaves", many, gen, flush, exclude=True,
                    clip=0.1, timed=False)
    torch.cuda.empty_cache()
    return dict(rows=rows, launch_floor_ms=floor, multi=multi)


# -- fused residual-add + LayerNorm (#6-#9) -----------------------------------

def _ln_case(torch, n, h, dtype, w_dtype, eps, gen, offset=False):
    """The four kernels vs their twins on one input: y, s, mu, rstd of both
    forwards and dx, dgamma, dbeta of both backwards (each backward twin
    given the kernel forward's own saved tensors); the backward run twice
    must give the same bits. ``offset``: every input row tensor is a
    contiguous [n, h] view that starts one value into a flat buffer, off a
    16-byte boundary whatever h. Returns the max errors."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    dt, wdt = getattr(torch, dtype), getattr(torch, w_dtype)

    def mk(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                + shift).to(dt if len(shape) == 2 else wdt)
    x, r = mk(n, h, scale=2.0, shift=0.5), mk(n, h)
    dy, ds = mk(n, h), mk(n, h)
    g, b = mk(h, scale=0.1, shift=1.0), mk(h, scale=0.1)
    if offset:
        x, r, dy, ds = (torch.empty(n * h + 1, dtype=dt, device="cuda")[1:]
                        .view(n, h).copy_(t) for t in (x, r, dy, ds))
        check(all(t.is_contiguous() and t.data_ptr() % 16
                  for t in (x, r, dy, ds)),
              f"fused-ln: the offset rows at h {h} start on a 16-byte "
              "boundary")
    y, s, mu, rstd = kln.fused_add_layer_norm_fwd(x, r, g, b, eps)
    bwd = [kln.fused_add_layer_norm_bwd(dy, ds, s, mu, rstd, g)
           for _ in range(2)]
    y8, mu8, rstd8 = kln.fused_add_layer_norm_y_fwd(x, r, g, b, eps)
    bwd9 = [kln.fused_add_layer_norm_y_bwd(dy, x, r, mu8, rstd8, g)
            for _ in range(2)]
    torch.cuda.synchronize()
    where = (f"{dtype} n{n} h{h} gamma {w_dtype} eps {eps}"
             + (" offset" if offset else ""))
    check(all(torch.equal(a, c) for run in (bwd, bwd9)
              for a, c in zip(*run)),
          f"fused-ln {where}: a second backward run differs")
    check(torch.equal(mu, mu8) and torch.equal(rstd, rstd8),
          f"fused-ln {where}: #6 and #8 row statistics differ")
    (dx, dg, db), (dx9, dg9, db9) = bwd[0], bwd9[0]
    t6 = kln.fused_add_layer_norm_fwd_plain(x, r, g, b, eps)
    t7 = kln.fused_add_layer_norm_bwd_plain(dy, ds, s, mu, rstd, g)
    t8 = kln.fused_add_layer_norm_y_fwd_plain(x, r, g, b, eps)
    t9 = kln.fused_add_layer_norm_y_bwd_plain(dy, x, r, mu8, rstd8, g)
    errs = {}
    for kern, name, a, p in (("fwd", "y", y, t6[0]), ("fwd", "s", s, t6[1]),
                             ("bwd", "dx", dx, t7[0]),
                             ("y_fwd", "y", y8, t8[0]),
                             ("y_bwd", "dx", dx9, t9[0])):
        # f32 absolute, bf16 of max(1, |twin|), float16 in ulps
        err, scaled = _err(a, p)
        ok = (err if dtype == "float32" else scaled) <= TOL[dtype]
        if dtype == "float16":
            ulps = f16_ulps(a, p)
            ok = ulps <= F16_ULPS
            errs[f"{kern}_{name}_ulps"] = ulps
        check(math.isfinite(err) and ok and a.dtype == p.dtype,
              f"fused-ln {where}: {kern} {name} max_abs_err {err} over the "
              f"{dtype} bar")
        errs[kern] = max(errs.get(kern, 0.0), err)
    # dgamma/dbeta: f32 sums over n rows in another order than the twin's,
    # held to 1e-4 of max(1, |twin|)
    for kern, name, a, p in (("bwd", "dgamma", dg, t7[1]),
                             ("bwd", "dbeta", db, t7[2]),
                             ("y_bwd", "dgamma", dg9, t9[1]),
                             ("y_bwd", "dbeta", db9, t9[2])):
        err, scaled = _err(a, p)
        check(a.dtype == torch.float32 and scaled <= 1e-4,
              f"fused-ln {where}: {kern} {name} max_abs_err {err} "
              f"({scaled} of max(1, |twin|))")
        errs[f"{kern}_{name}"] = err
    # row statistics, f32 on both sides: mu to 1e-4, rstd to 1e-4 of its
    # size (it reaches 1/sqrt(eps) on a flat row)
    errs["mu"] = _err(mu, t6[2])[0]
    errs["rstd_rel"] = ((rstd - t6[3]).abs() / t6[3]).max().item()
    check(errs["mu"] <= 1e-4 and errs["rstd_rel"] <= 1e-4,
          f"fused-ln {where}: mu err {errs['mu']}, rstd relative err "
          f"{errs['rstd_rel']}")
    return dict(dtype=dtype, n=n, h=h, w_dtype=w_dtype, eps=eps,
                offset=offset, err=errs)


def _ln_bounds(n, h):
    """(bound ms, what bounds it) of the four kernels on [n, h] bf16 rows
    and bf16 parameters: bytes (each input read once, each output written
    once; the backward's partial rows are the kernel's own scratch) and ~8
    FLOPs an element forward, ~12 backward."""
    rows_b, vec_b = n * h * 2, h * 2         # bf16 rows and parameters
    stat = n * 4                             # mu or rstd, f32
    bwd = (4 * rows_b + vec_b + 2 * stat + 2 * h * 4, 12 * n * h)
    work = {
        "fused_add_layer_norm_fwd": (4 * rows_b + 2 * vec_b + 2 * stat,
                                     8 * n * h),
        "fused_add_layer_norm_y_fwd": (3 * rows_b + 2 * vec_b + 2 * stat,
                                       8 * n * h),
        "fused_add_layer_norm_bwd": bwd,
        "fused_add_layer_norm_y_bwd": bwd,
    }
    return {k: bound(*w) for k, w in work.items()}


def _ln_library(torch, x, r, dy, g, b, h, flush):
    """Held ms of PyTorch's calls beside the kernels, on bf16 rows: its own
    LayerNorm backward (aten.native_layer_norm_backward: dy and the saved
    sum s -> dx, dgamma, dbeta in one call, with mean and rstd as
    native_layer_norm gives them on the card; it reads one row tensor fewer
    than #9, which rebuilds s from x and r, and lacks #7's + ds), and the
    eager pair F.layer_norm(x + r) with its autograd backward (no single
    call adds and normalises)."""
    aten = torch.ops.aten
    s = x + r
    _, mean, rstd = aten.native_layer_norm(s, [h], g, b, 1e-5)
    back = lambda: aten.native_layer_norm_backward(  # noqa: E731
        dy, s, [h], mean, rstd, g, b, [True, True, True])
    out = {"native_bwd_ms": time_ms(torch, back, flush=flush)}
    ln = torch.nn.functional.layer_norm
    out["eager_fwd_ms"] = time_ms(torch, lambda: ln(x + r, (h,), g, b, 1e-5),
                                  flush=flush)
    xl, rl, gl, bl = (t.detach().clone().requires_grad_()
                      for t in (x, r, g, b))
    y = ln(xl + rl, (h,), gl, bl, 1e-5)
    out["eager_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        y, (xl, rl, gl, bl), dy, retain_graph=True), flush=flush)
    return out


def _ln_timing(torch, n, h, gen, flush, dtype="bfloat16"):
    """ms of the four kernels and their twins at one slice shape (rows and
    parameters in ``dtype``, bf16 or float16, as the Engine's AMP gives
    them), the bound of each (the same bytes in either), and PyTorch's
    calls beside them (_ln_library)."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    bf = getattr(torch, dtype)
    x, r, dy, ds = (torch.randn(n, h, generator=gen, device="cuda").to(bf)
                    for _ in range(4))
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf)
    b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf)
    y, s, mu, rstd = kln.fused_add_layer_norm_fwd(x, r, g, b, 1e-5)
    kern = {
        "fused_add_layer_norm_fwd": lambda: kln.fused_add_layer_norm_fwd(
            x, r, g, b, 1e-5),
        "fused_add_layer_norm_bwd": lambda: kln.fused_add_layer_norm_bwd(
            dy, ds, s, mu, rstd, g),
        "fused_add_layer_norm_y_fwd": lambda: kln.fused_add_layer_norm_y_fwd(
            x, r, g, b, 1e-5),
        "fused_add_layer_norm_y_bwd": lambda: kln.fused_add_layer_norm_y_bwd(
            dy, x, r, mu, rstd, g),
    }
    plain = {
        "fused_add_layer_norm_fwd":
            lambda: kln.fused_add_layer_norm_fwd_plain(x, r, g, b, 1e-5),
        "fused_add_layer_norm_bwd":
            lambda: kln.fused_add_layer_norm_bwd_plain(dy, ds, s, mu, rstd,
                                                       g),
        "fused_add_layer_norm_y_fwd":
            lambda: kln.fused_add_layer_norm_y_fwd_plain(x, r, g, b, 1e-5),
        "fused_add_layer_norm_y_bwd":
            lambda: kln.fused_add_layer_norm_y_bwd_plain(dy, x, r, mu, rstd,
                                                         g),
    }
    row = {"ms": {k: time_ms(torch, f, flush=flush) for k, f in kern.items()},
           "plain_ms": {k: time_ms(torch, f, flush=flush)
                        for k, f in plain.items()}}
    row.update(_ln_library(torch, x, r, dy, g, b, h, flush))
    row["bound"] = _ln_bounds(n, h)
    return row


# the backward's new cases: widths that cut its 16-byte chunks and lanes
# (100: bf16 rows of 200 bytes; 1000: 125 bf16 or 250 f32 chunks), and
# rows that start off a 16-byte boundary (one value into a buffer)
LN_RAGGED = ((7, 100), (8192, 100), (7, 1000), (16384, 1000))
LN_OFFSET = ((8192, 1023, "bfloat16"), (8192, 101, "bfloat16"),
             (8192, 1023, "float32"), (4096, 2048, "bfloat16"),
             (4096, 3000, "bfloat16"), (4096, 3000, "float32"))
# rows wider than 1024 values, W = ceil(h / 512) warps a row, 16 // W rows
# a block of 16 warps: three slices of 344 / 344 / 337 values (1025) and of
# 512 (1536), four (2048, GPT-1.3B's width), five (2056: slices of 416 and
# a last of 392 bf16 / 408 f32), six (3000: rows of 6000 bytes, not
# 16-byte multiples), eight (4096) and sixteen (8192, MAX_H)
LN_WIDE = (1025, 1536, 2048, 2056, 3000, 4096, 8192)
# the backward's widths held against its plan: one warp a row, and wide
# (4608: nine warps a row, seven of a block left over)
LN_RESIDENCY = (64, 100, 768, 1000, 1024) + LN_WIDE + (4608,)


def _ln_residency(torch):
    """The backward's row kernel as the card resides it, against its plan:
    each (#7, #9) x (f32, bf16) x h in LN_RESIDENCY must reside as many
    blocks an SM as the plan counts on (so the grid is one wave), exactly
    as many for a wide row (its shared memory sets them), with the plan's
    shared memory and no local (spill) bytes."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for h in LN_RESIDENCY:
            for kern, with_sum in (("#7", True), ("#9", False)):
                plan = kln.bwd_plan(16384, h, dtype)
                res = kln.bwd_residency(h, dtype, with_sum)
                tag = f"{kern} {str(dtype)[6:]} h{h}"
                log(f"fused-ln: backward {tag}: {plan.chunks} chunks a lane, "
                    f"{res['registers']} registers, {res['smem']} B shared, "
                    f"{res['spill_bytes']} local bytes; "
                    f"{res['blocks_per_sm']} blocks an SM resident (plan "
                    f"{plan.blocks_per_sm}), grid at n = 16384 "
                    f"{plan.blocks} (one wave: "
                    f"{plan.blocks <= 132 * res['blocks_per_sm']})")
                resident = res["blocks_per_sm"]
                check((resident == plan.blocks_per_sm if h > 1024 else
                       resident >= plan.blocks_per_sm)
                      and res["smem"] == plan.smem
                      and res["spill_bytes"] == 0,
                      f"fused-ln: backward {tag} resides {res} against the "
                      f"plan {plan}")
                out[tag] = dict(res, plan=plan._asdict())
    return out


def phase_fused_ln(torch, flush):
    """Kernels #6-#9 vs their twins: f32 and bf16, H in {64, 768, 1024},
    N in {7, 8192, 16384}, eps 1e-12 and 1e-5, gamma/beta in f32 and in
    the rows' dtype, plus H = 100 and 1000, the wide rows of LN_WIDE at
    N in {7, 4096}, and rows off a 16-byte boundary (LN_RAGGED, LN_OFFSET);
    a width above the kernels' raises; the backward resides as its plan
    counts on (_ln_residency); times at the three slice shapes (ERNIE:
    N=16384 H=768; GPT: N=8192 H=1024; GPT-1.3B: N=4096 H=2048; bf16)."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    cells = [(n, h) for n in (7, 8192, 16384) for h in (64, 768, 1024)]
    for k, (n, h) in enumerate(cells + list(LN_RAGGED)):
        for dtype in ("float32", "bfloat16"):
            for j, eps in enumerate((1e-12, 1e-5)):
                # bf16 rows meet f32 and bf16 parameters at each eps
                w_dtype = dtype if (k + j) % 2 else "float32"
                rows.append(_ln_case(torch, n, h, dtype, w_dtype, eps, gen))
    for k, h in enumerate(LN_WIDE):
        for n in (7, 4096):
            for dtype in ("float32", "bfloat16"):
                for j, eps in enumerate((1e-12, 1e-5)):
                    w_dtype = dtype if (k + j) % 2 else "float32"
                    rows.append(_ln_case(torch, n, h, dtype, w_dtype, eps,
                                         gen))
    for n, h, dtype in LN_OFFSET:
        rows.append(_ln_case(torch, n, h, dtype, "float32", 1e-5, gen,
                             offset=True))
    for r in rows:
        errs = " ".join(f"{k} {v:.2e}" for k, v in r["err"].items())
        log(f"fused-ln: {r['dtype']} n{r['n']} h{r['h']} gamma "
            f"{r['w_dtype']} eps {r['eps']}"
            + (" offset" if r["offset"] else "") + f": {errs}")
    log("fused-ln: dgamma/dbeta and dx identical over two backward runs in "
        f"all {len(rows)} cases")
    residency = _ln_residency(torch)
    wide = torch.zeros(4, kln.MAX_H + 32, device="cuda")
    wg = torch.ones(kln.MAX_H + 32, device="cuda")
    try:
        kln.fused_add_layer_norm_fwd(wide, wide, wg, wg)
    except ValueError as e:
        check("queue 2" in str(e), f"fused-ln: the raise names no ROADMAP "
              f"queue: {e}")
        log(f"fused-ln: H = {kln.MAX_H + 32} raises: {e}")
    else:
        raise SmokeFailure("fused-ln: a row wider than MAX_H did not raise")
    timing = {"ernie": _ln_timing(torch, 16384, 768, gen, flush),
              "gpt": _ln_timing(torch, 8192, 1024, gen, flush),
              "gpt-1.3b": _ln_timing(torch, 4096, 2048, gen, flush)}
    for shape, tm in timing.items():
        for k in tm["ms"]:
            bms, by = tm["bound"][k]
            log(f"fused-ln: {shape} shape {k}: ms {tm['ms'][k]:.4f} plain_ms "
                f"{tm['plain_ms'][k]:.4f} bound_ms {bms:.4f} ({by})")
        log(f"fused-ln: {shape} shape native_layer_norm_backward ms "
            f"{tm['native_bwd_ms']:.4f}; eager F.layer_norm(x + r): forward "
            f"ms {tm['eager_fwd_ms']:.4f}, autograd backward ms "
            f"{tm['eager_bwd_ms']:.4f}")
    return dict(rows=rows, timing=timing, residency=residency)


def _ln_bwd_call(torch, fn, rows, mu, rstd, g, blocks):
    """A callable that launches a fused_ln.cu's backward entry ``fn`` on
    ``rows`` = (dy, ds, a, b) (ds or b None: #9 or #7) at ``blocks``
    blocks and returns (dx, dgamma, dbeta)."""
    dy, ds, a, b = rows
    n, h = dy.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def run():
        dx = torch.empty_like(dy)
        part = torch.empty(2, blocks, h, dtype=torch.float32, device="cuda")
        dgb = torch.empty(2, h, dtype=torch.float32, device="cuda")
        err = fn(ptr(dy), ptr(ds), ptr(a), ptr(b), ptr(mu), ptr(rstd), ptr(g),
                 ptr(dx), ptr(part[0]), ptr(part[1]), ptr(dgb[0]),
                 ptr(dgb[1]), n, h, blocks, int(dy.dtype == torch.bfloat16),
                 int(g.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"compare-ln: backward launch failed ({err})")
        return dx, dgb[0], dgb[1]
    return run


def _ln_fwd_call(torch, fn, x, r, g, b, with_sum):
    """A callable that launches a fused_ln.cu's forward entry ``fn`` on
    [n, h] rows x, r (#6 with ``with_sum``, else #8) and returns (y, s or
    None, mu, rstd)."""
    n, h = x.shape

    def run():
        y = torch.empty_like(x)
        s = torch.empty_like(x) if with_sum else None
        mu = torch.empty(n, dtype=torch.float32, device="cuda")
        rstd = torch.empty_like(mu)
        err = fn(x.data_ptr(), r.data_ptr(), g.data_ptr(), b.data_ptr(),
                 y.data_ptr(), None if s is None else s.data_ptr(),
                 mu.data_ptr(), rstd.data_ptr(), n, h, 1e-5,
                 int(x.dtype == torch.bfloat16),
                 int(g.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"compare-ln: forward launch failed ({err})")
        return y, s, mu, rstd
    return run


def _ln_kernel_ms(torch, fn, flush, reps=5):
    """{kernel: device ms a call} of the LN backward's two kernels
    (ln_bwd_kernel, colsum_kernel) over ``reps`` calls of fn, L2 flushed
    between them (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for a in prof.key_averages():
        for name in ("ln_bwd_kernel", "colsum_kernel"):
            if a.device_type == DeviceType.CUDA and name in a.key:
                out[name] = out.get(name, 0.0) + \
                    a.self_device_time_total / 1e3 / reps
    return out


def compare_ln(torch, sources):
    """``--compare-ln SRC...``: build each given fused_ln.cu (its parent
    from git, a variant) with the package's flags; hold its forwards' y,
    s, mu and rstd to the package's #6 and #8 (y, s 2e-2 and mu, rstd
    1e-4, of max(1, |ours|)) and its backward's dx, dgamma and dbeta to
    the package's #7 and #9 (bf16 dx 2e-2 and dgamma/dbeta 1e-4, of
    max(1, |ours|)); time each pair in turns (theirs, ours, ours, theirs;
    held) at ERNIE's (16384 x 768) and GPT's (8192 x 1024) bf16 shapes
    beside the bound; the backwards also beside
    aten.native_layer_norm_backward and the eager F.layer_norm(x + r)
    pair (held), and torch.addcmul over as many row bytes (the floor one
    elementwise pass reaches); then each source at grids of 132 x {1, ...,
    5} blocks, each side's two kernels (ln_bwd_kernel, colsum_kernel)
    under the profiler, and ours with L2 evicted by a read. A source whose
    fused_ln_bwd takes another argument list than the package's is
    refused; one without the residency entry (the parent's design) runs
    at its own grid, min(ceil(n / 4), 528)."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    entries = []
    for src, cdll in _build_compare(sources, "ln"):
        with open(src) as f:
            text = f.read()
        sig = re.search(r'extern "C" int fused_ln_bwd\(([^)]*)\)', text)
        check(sig is not None, f"compare-ln: {src} has no fused_ln_bwd")
        nargs = len(sig.group(1).split(","))
        check(nargs == len(kln._BWD_ARGTYPES),
              f"compare-ln: {src}'s fused_ln_bwd takes {nargs} arguments, "
              f"the package's {len(kln._BWD_ARGTYPES)}")
        fn = cdll.fused_ln_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = kln._BWD_ARGTYPES
        fwd = cdll.fused_ln_fwd
        fwd.restype = ctypes.c_int
        fwd.argtypes = kln._FWD_ARGTYPES
        entries.append((src, fn, "fused_ln_bwd_residency" in text, fwd))
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf = torch.bfloat16
    for tag, n, h in (("ernie", 16384, 768), ("gpt", 8192, 1024)):
        x, r, dy, ds = (torch.randn(n, h, generator=gen, device="cuda").to(bf)
                        for _ in range(4))
        g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf)
        b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf)
        _, s, mu, rstd = kln.fused_add_layer_norm_fwd(x, r, g, b, 1e-5)
        lib = _ln_library(torch, x, r, dy, g, b, h, flush)
        log(f"compare-ln {tag}: native_layer_norm_backward held "
            f"{lib['native_bwd_ms']:.4f} ms (unheld "
            f"{unheld(lib['native_bwd_ms']):.4f}); eager F.layer_norm(x + r) "
            f"forward {lib['eager_fwd_ms']:.4f}, its autograd backward "
            f"{lib['eager_bwd_ms']:.4f}")
        # what one elementwise pass over as many row bytes reaches under
        # the same flush: three bf16 row tensors read, one written
        out4 = torch.empty_like(dy)
        rows_ms = bound(4 * n * h * 2, 0)[0]
        floor = [time_ms(torch, lambda: torch.addcmul(dy, x, r, out=out4),
                         flush=f) for f in (flush, scratch.sum)]
        log(f"compare-ln {tag}: torch.addcmul(dy, x, r) into a fourth row "
            f"tensor (#9's row bytes, one pass) held {floor[0]:.4f} ms, "
            f"{rows_ms / floor[0]:.3f} of its {rows_ms:.4f} ms bound; with "
            f"L2 evicted by a read (clean lines) {floor[1]:.4f} ms")
        del out4
        forwards = (
            ("#6", "fused_add_layer_norm_fwd", True,
             lambda: kln.fused_add_layer_norm_fwd(x, r, g, b, 1e-5)),
            ("#8", "fused_add_layer_norm_y_fwd", False,
             lambda: kln.fused_add_layer_norm_y_fwd(x, r, g, b, 1e-5)))
        for kern, name, with_sum, ours in forwards:
            want = ours()
            want = want if with_sum else (want[0], None) + want[1:]
            bms, by = _ln_bounds(n, h)[name]
            for src, _, _, fwd in entries:
                theirs = _ln_fwd_call(torch, fwd, x, r, g, b, with_sum)
                got = theirs()
                e_y = max(_err(a, w)[1] for a, w in zip(got[:2], want[:2])
                          if a is not None)
                e_st = max(_err(a, w)[1] for a, w in zip(got[2:], want[2:]))
                check(e_y <= TOL["bfloat16"] and e_st <= 1e-4,
                      f"compare-ln {tag} {kern}: {src} differs from the "
                      f"package's: y/s {e_y}, mu/rstd {e_st}")
                ms, t_ms, o_ms = _in_turns(torch, theirs, ours, flush)
                log(f"compare-ln {tag} {kern}: {src}: held ms in turns "
                    f"(theirs, ours, ours, theirs): theirs "
                    f"{ms['theirs'][0]:.4f} {ms['theirs'][1]:.4f}, ours "
                    f"{ms['ours'][0]:.4f} {ms['ours'][1]:.4f}; theirs / ours "
                    f"= {t_ms / o_ms:.3f}; of the bound {bms:.4f} ms ({by}): "
                    f"theirs {bms / t_ms:.3f}, ours {bms / o_ms:.3f}; err y/s "
                    f"{e_y:.2e}, mu/rstd {e_st:.2e}")
        plan = kln.bwd_plan(n, h, bf)
        kernels = (
            ("#7", "fused_add_layer_norm_bwd", (dy, ds, s, None),
             lambda: kln.fused_add_layer_norm_bwd(dy, ds, s, mu, rstd, g)),
            ("#9", "fused_add_layer_norm_y_bwd", (dy, None, x, r),
             lambda: kln.fused_add_layer_norm_y_bwd(dy, x, r, mu, rstd, g)))
        for kern, name, rows, ours in kernels:
            want = ours()
            bms, by = _ln_bounds(n, h)[name]
            log(f"compare-ln {tag} {kern}: ours {plan}; kernels under the "
                f"profiler (ms a call): "
                f"{_ln_kernel_ms(torch, ours, flush)}; held with L2 evicted "
                f"by a read (clean lines) "
                f"{time_ms(torch, ours, flush=scratch.sum):.4f} ms")
            for src, fn, planned, _ in entries:
                blocks = plan.blocks if planned else min(-(-n // 4), 528)
                theirs = _ln_bwd_call(torch, fn, rows, mu, rstd, g, blocks)
                got = theirs()
                e_dx = _err(got[0], want[0])[1]
                e_gb = max(_err(a, w)[1] for a, w in zip(got[1:], want[1:]))
                check(e_dx <= TOL["bfloat16"] and e_gb <= 1e-4,
                      f"compare-ln {tag} {kern}: {src} differs from the "
                      f"package's: dx {e_dx}, dgamma/dbeta {e_gb} (of "
                      "max(1, |ours|))")
                ms, t_ms, o_ms = _in_turns(torch, theirs, ours, flush)
                log(f"compare-ln {tag} {kern}: {src} ({blocks} blocks): held "
                    f"ms in turns (theirs, ours, ours, theirs): theirs "
                    f"{ms['theirs'][0]:.4f} {ms['theirs'][1]:.4f}, ours "
                    f"{ms['ours'][0]:.4f} {ms['ours'][1]:.4f}; theirs / ours "
                    f"= {t_ms / o_ms:.3f}; of the bound {bms:.4f} ms ({by}): "
                    f"theirs {bms / t_ms:.3f}, ours {bms / o_ms:.3f}; "
                    f"native_layer_norm_backward / ours = "
                    f"{lib['native_bwd_ms'] / o_ms:.2f}; err dx {e_dx:.2e}, "
                    f"dgamma/dbeta {e_gb:.2e}")
                log(f"compare-ln {tag} {kern}: {src}: kernels under the "
                    f"profiler (ms a call): "
                    f"{_ln_kernel_ms(torch, theirs, flush)}")
                grids = []
                for k in range(1, 6):
                    t = time_ms(torch, _ln_bwd_call(torch, fn, rows, mu, rstd,
                                                    g, 132 * k), flush=flush)
                    grids.append(f"{132 * k}: {t:.4f}")
                log(f"compare-ln {tag} {kern}: {src}: held ms by grid "
                    f"(blocks: ms): {', '.join(grids)}")


def compare_conv(torch, sources):
    """``--compare-conv SRC...``: build each given conv_bn_act.cu (its
    parent from git, a variant; the package's C entry and argument list)
    with the package's flags; hold its output to the package's kernel at
    the dtype's bar (f32 1e-4, bf16 2e-2, of max(1, |ours|)) and time both
    held in turns (theirs, ours, ours, theirs) at the 12 shapes of one
    ResNet-50 forward at batch 256 x 224 px, in f32 and in bf16, beside
    cuBLAS's GEMM of the same operands alone (TF32 off; it computes less
    than #11) and the bound (conv_bound: f32 in 3xTF32, with the CUDA
    cores' bound beside it), in f32 with each side's distance from the
    float64 product (and the twin's; ours held to F32_EXACT_TOL); then
    the 32-launch (serve,
    evaluate) and 17-launch (training) sums. ptxas's registers and spills
    of every instantiation are printed as each source builds."""
    from paddle_tpu_torch.ops.kernels import conv_bn_act as kcb
    entries = []
    for src, cdll in _build_compare(sources, "conv"):
        fn = cdll.conv_bn_act
        fn.restype, fn.argtypes = ctypes.c_int, kcb._ARGTYPES
        entries.append((src, fn))
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(14)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        rows = {src: [] for src, _ in entries}
        for m, cin, cout, res, _ in SERVE_SHAPES:
            x2 = torch.randn(m, cin, generator=gen, device="cuda").to(dt)
            w = (torch.randn(cin, cout, generator=gen, device="cuda")
                 / math.sqrt(cin)).to(dt)
            scale = 1.0 + 0.1 * torch.randn(cout, generator=gen,
                                            device="cuda")
            shift = 0.1 * torch.randn(cout, generator=gen, device="cuda")
            r2 = torch.randn(m, cout, generator=gen, device="cuda").to(dt) \
                if res else None

            def ours():
                return kcb.fused_conv1x1_bn_act(x2, w, scale, shift, r2)
            want = ours().float()
            gemm = time_ms(torch, lambda: torch.matmul(x2, w), flush=flush)
            bd = conv_bound(m, cin, cout, res, dtype)
            exact = None
            if dtype == "float32":
                # each side's distance from the float64 product, of
                # max(1, |y|): the twin's is the f32 CUDA-core GEMM's
                exact = _conv_exact(x2, w, scale, shift, r2)
                scale64 = exact.abs().clamp_min(1.0)

                def far(y):
                    return ((y.double() - exact).abs() / scale64).max().item()
                twin = kcb.conv_bn_act_plain(x2, w, scale, shift, r2)
                log(f"compare-conv float32 M={m} {cin}->{cout} res={res}: "
                    f"from float64, of max(1, |y|): ours {far(want):.2e}, "
                    f"the twin (cuBLAS f32) {far(twin):.2e}")
                check(far(want) <= F32_EXACT_TOL,
                      f"compare-conv float32 M={m} {cin}->{cout}: ours is "
                      f"{far(want)} of max(1, |y|) from float64")
                del twin
            for src, fn in entries:
                y = torch.empty(m, cout, dtype=dt, device="cuda")

                def theirs(fn=fn, y=y):
                    err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                             shift.data_ptr(),
                             0 if r2 is None else r2.data_ptr(),
                             y.data_ptr(), m, cin, cout,
                             int(dt == torch.bfloat16), 1,
                             torch.cuda.current_stream().cuda_stream)
                    check(err == 0, f"compare-conv: {src}: CUDA error {err}")
                    return y
                got = theirs().float()
                e = ((got - want).abs()
                     / want.abs().clamp_min(1.0)).max().item()
                if exact is not None:
                    log(f"compare-conv float32 M={m} {cin}->{cout}: {src} "
                        f"from float64 {far(got):.2e}")
                check(math.isfinite(e) and e <= TOL[dtype],
                      f"compare-conv {dtype} M={m} {cin}->{cout}: {src} "
                      f"differs from the package's by {e} of max(1, |ours|)")
                ms, t_ms, o_ms = _in_turns(torch, theirs, ours, flush)
                rows[src].append(dict(theirs=t_ms, ours=o_ms, gemm=gemm,
                                      **bd))
                log(f"compare-conv {dtype} M={m} {cin}->{cout} res={res}: "
                    f"{src}: held ms in turns (theirs, ours, ours, theirs): "
                    f"theirs {ms['theirs'][0]:.4f} {ms['theirs'][1]:.4f}, "
                    f"ours {ms['ours'][0]:.4f} {ms['ours'][1]:.4f}; theirs "
                    f"/ ours = {t_ms / o_ms:.3f}; bound {bd['bound_ms']:.4f} "
                    f"ms ({bd['bound_by']}): theirs "
                    f"{bd['bound_ms'] / t_ms:.3f}, ours "
                    f"{bd['bound_ms'] / o_ms:.3f} of it"
                    + (f" (CUDA cores' {bd['cuda_core_bound_ms']:.4f} ms)"
                       if "cuda_core_bound_ms" in bd else "")
                    + f"; GEMM alone {gemm:.4f}; err {e:.2e}")
            del x2, w, r2, want, exact
        for src, rs in rows.items():
            for what, counts in (
                    ("32 launches of a forward",
                     [n for *_, n in SERVE_SHAPES]),
                    ("17 launches of a training forward",
                     [TRAIN_SHAPES.get(i, 0)
                      for i in range(len(SERVE_SHAPES))])):
                tot = {k: sum(r[k] * n for r, n in zip(rs, counts))
                       for k in ("theirs", "ours", "gemm", "bound_ms")}
                cc = ""
                if dtype == "float32":
                    cc = sum(r["cuda_core_bound_ms"] * n
                             for r, n in zip(rs, counts))
                    cc = f"; the CUDA cores' bound {cc:.4f}"
                log(f"compare-conv {dtype}: {src}: the {what}: theirs "
                    f"{tot['theirs']:.4f} ms, ours {tot['ours']:.4f} ms "
                    f"(theirs / ours = {tot['theirs'] / tot['ours']:.3f}); "
                    f"bound {tot['bound_ms']:.4f} ms (theirs "
                    f"{tot['bound_ms'] / tot['theirs']:.3f}, ours "
                    f"{tot['bound_ms'] / tot['ours']:.3f} of it){cc}; GEMM "
                    f"alone {tot['gemm']:.4f} ms")


def _train_engine(torch, cfg, device, amp=None, weight_seed=0,
                  capture=False):
    """gpt through Engine(GPTPretrainingCriterion, AdamW(1e-4, weight_decay
    0.01, fused_kernel=True)); eager unless ``capture`` (None: the
    package's Engine as it comes, for a tree whose Engine has no
    ``capture``)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.gpt import (GPTForCausalLM,
                                          GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, device=device,
                           generator=seed(weight_seed, device=device)).train()
    eng = Engine(model, loss=GPTPretrainingCriterion(),
                 optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 fused_kernel=True), amp_dtype=amp,
                 **({} if capture is None else dict(capture=capture)))
    return model, eng


def _batch(cfg, b, s, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


class _AdamWWatch:
    """Over a run: the multi-leaf AdamW wrapper's leaves, and the calls of
    the plain update on f32 leaves (the optimizer module's
    adamw_update_plain wrapped for the run)."""

    def __enter__(self):
        import torch
        from paddle_tpu_torch.ops.kernels import fused_adamw as ka
        from paddle_tpu_torch.optimizer import optimizer as om
        self._om, self._orig = om, om.adamw_update_plain
        ka.fused_adamw_multi_update.leaves = 0
        self.plain_f32 = 0

        def counted(p, *args, **kw):
            self.plain_f32 += p.dtype == torch.float32
            return self._orig(p, *args, **kw)
        om.adamw_update_plain = counted
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops.kernels import fused_adamw as ka
        self._om.adamw_update_plain = self._orig
        self.leaves = ka.fused_adamw_multi_update.leaves


def _check_adamw_route(tag, model, opt, watch, launches, steps):
    """Every f32 leaf went through the multi-leaf kernel each step, in
    ceil(leaves / MAX_LEAVES) launches, and the plain update ran on no f32
    leaf. -> f32 leaves."""
    import torch
    from paddle_tpu_torch.ops.kernels.fused_adamw import MAX_LEAVES
    f32 = sum(p.dtype == opt._state[n]["m"].dtype == opt._state[n]["v"].dtype
              == torch.float32 for n, p in model.named_parameters()
              if p.requires_grad)
    per_step = -(-f32 // MAX_LEAVES)
    got = (launches["fused_adamw_multi_update"], watch.leaves,
           watch.plain_f32)
    want = (per_step * steps, f32 * steps, 0)
    check(got == want, f"{tag}: AdamW (launches, leaves, plain updates of "
          f"f32 leaves) over {steps} steps {got}, want {want}")
    log(f"{tag}: AdamW: {f32} f32 leaves a step through the multi-leaf "
        f"kernel in {per_step} launch(es); none on the plain path")
    return f32


# device kernels of a transformer training step, grouped by name (first
# match wins)
LM_TRAIN_GROUPS = (
    ("#1 (flash forward)", ("flash_fwd",)),
    ("#3/#4 (flash backward)", ("flash_bwd",)),
    ("#6-#9 (fused LayerNorm)", ("ln_fwd", "ln_bwd", "colsum")),
    ("#10 (adamw_kernel)", ("adamw_kernel",)),
    ("GEMMs", ("gemm", "cutlass", "cublas", "sm90_xmma", "nvjet")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("foreach", ("multi_tensor_apply",)),
    ("elementwise and reductions (casts, activations, the loss)",
     ("elementwise", "reduce", "copy", "fill", "cat", "index", "softmax",
      "nll", "gather", "scatter")),
)


def phase_train(torch):
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    b, s, warm, steps = 8, 1024, 3, 10
    cfg = _resolve_config("gpt3-345M", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    t0 = time.perf_counter()
    model, eng = _train_engine(torch, cfg, "cuda", amp=torch.bfloat16)
    ids, labels = _batch(cfg, b, s, "cuda")
    torch.cuda.synchronize()
    log(f"train: gpt3-345M built on cuda in {time.perf_counter() - t0:.2f} "
        f"s ({sum(p.numel() for p in model.parameters())} parameters, "
        f"{cfg.num_hidden_layers} layers); batch {b} x {s}, bf16 AMP, "
        "AdamW(1e-4, weight_decay=0.01, fused_kernel=True)")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warm):
        t0 = time.perf_counter()
        losses.append(eng.train_batch([ids], [labels])[0])
        torch.cuda.synchronize()
        log(f"train: warm-up step {i}: {time.perf_counter() - t0:.3f} s, "
            f"loss {losses[-1].item():.4f}")
    opt = eng.optimizer
    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _AdamWWatch() as watch:
        for _ in range(steps):
            losses.append(eng.train_batch([ids], [labels])[0])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    log(f"train: kernel launches over {steps} steps: {launches}")
    per_layer = cfg.num_hidden_layers * steps
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        check(launches[name] == per_layer, f"train: {name} launched "
              f"{launches[name]} times in {steps} steps, want {per_layer}")
    leaves = _check_adamw_route("train", model, opt, watch, launches, steps)
    vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in vals), f"train: loss {vals}")
    check(vals[-1] < vals[0], f"train: loss did not fall: {vals}")
    tok_s = b * s * steps / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train: {steps} steps in {wall:.3f} s = {wall / steps * 1e3:.2f} ms"
        f"/step, {tok_s:.1f} tokens/s; loss {vals[0]:.4f} -> {vals[-1]:.4f};"
        f" max_memory_allocated {peak_gb:.2f} GiB")
    prof = profile_grouped(torch, "train", "one training step",
                           lambda: eng.train_batch([ids], [labels]),
                           LM_TRAIN_GROUPS)
    return dict(launches=launches, adamw_leaves=leaves, tok_s=tok_s,
                ms_per_step=wall / steps * 1e3, peak_gb=peak_gb,
                losses=vals, **prof)


def _cross_device_step(tag, what, models, engines, batches, crit,
                       zero_grads=("k_proj.bias",), linear_step=False):
    """One training step on the card and on the CPU from the same weights:
    the gradients of crit(model(*inputs), *labels) on each device, then one
    Engine.train_batch each; loss, gradients and the parameters after the
    step held to the bars below. ``batches``: {device: (inputs, labels)};
    ``zero_grads``: name suffixes of the leaves whose gradient is zero in
    exact arithmetic; ``linear_step``: the optimizer's first step is lr
    times the gradient (Momentum, SGD), not Adam's."""
    grads = {}
    for dev, m in models.items():
        inputs, labels = batches[dev]
        outs = m(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        crit(*outs, *labels).backward()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in
                      m.named_parameters()}
        for p in m.parameters():
            p.grad = None
    # every leaf within 1e-3 of its max-abs; the key bias is zero in exact
    # arithmetic (softmax ignores a shift shared by every key), as is a
    # convolution's bias ahead of a BatchNorm, so on both devices it is
    # rounding noise, held to 1e-3 of the model's largest gradient instead
    scale = max(g.abs().max().item() for g in grads["cpu"].values())
    worst, noise = 0.0, 0.0
    for n, g in grads["cpu"].items():
        if n.endswith(tuple(zero_grads)):
            noise = max(noise, g.abs().max().item(),
                        grads["cuda"][n].abs().max().item())
            continue
        rel = (grads["cuda"][n] - g).abs().max().item() / max(
            g.abs().max().item(), 1e-30)
        check(math.isfinite(rel) and rel <= 1e-3,
              f"{tag}: grad {n} differs by {rel} of its max-abs")
        worst = max(worst, rel)
    check(noise <= 1e-3 * scale, f"{tag}: key-bias grads reach {noise}, "
          f"not noise against the largest gradient {scale}")
    loss = {dev: e.train_batch(*batches[dev])[0].item()
            for dev, e in engines.items()}
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    check(rel <= 1e-4, f"{tag}: loss cuda {loss['cuda']} vs cpu "
          f"{loss['cpu']} ({rel} relative)")
    # Adam's first step moves an element by lr * g / (|g| + eps): flat to
    # 1 % of lr where |g| >= 1e-6 = 100 eps on both devices, but a step
    # function of g near eps, where grads that agree to 1e-3 of their
    # leaf's max-abs can still move it by different fractions of lr. The
    # flat part is held to 1e-5, the rest to 2 * lr.
    lr = engines["cuda"].optimizer.get_lr()
    if linear_step:
        return _linear_step_params(tag, what, models, grads, loss, rel,
                                   worst, noise, scale, lr)
    perr, worst_leaf, steep_err, n_steep = 0.0, "", 0.0, 0
    for (n, a), b in zip(models["cuda"].named_parameters(),
                         models["cpu"].parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        steep = ((grads["cpu"][n].abs() < 1e-6)
                 | (grads["cuda"][n].abs() < 1e-6))
        if (~steep).any() and diff[~steep].max().item() > perr:
            perr, worst_leaf = diff[~steep].max().item(), n
        if steep.any():
            steep_err = max(steep_err, diff[steep].max().item())
            n_steep += int(steep.sum().item())
    check(perr <= 1e-5, f"{tag}: params after the step differ by {perr}"
          f" ({worst_leaf})")
    check(steep_err <= 2 * lr, f"{tag}: params with |grad| < 1e-6 "
          f"differ by {steep_err} after the step, more than 2 * lr")
    log(f"{tag}: {what}: loss cuda "
        f"{loss['cuda']:.6f} cpu {loss['cpu']:.6f} ({rel:.2e} relative); "
        f"worst grad leaf {worst:.2e} of its max-abs over "
        f"{len(grads['cpu'])} leaves (key-bias grads, zero in exact "
        f"arithmetic: {noise:.2e} against the largest gradient "
        f"{scale:.2e}); params after the step max_abs_err {perr:.2e} "
        f"({worst_leaf}) where |grad| >= 1e-6, {steep_err:.2e} over the "
        f"{n_steep} elements where |grad| < 1e-6 on a device")
    return dict(loss_rel=rel, grad_rel=worst, param_err=perr)


def _linear_step_params(tag, what, models, grads, loss, rel, worst, noise,
                        scale, lr):
    """The parameters after a first step that is lr times the gradient
    (plus an L2 term of the same parameters on both devices): each leaf
    within 1e-5 plus lr times the gradient bar (1e-3 of the leaf's
    gradient max-abs), the gradients' agreement carried through the
    step."""
    perr, worst_leaf = 0.0, ""
    for (n, a), b in zip(models["cuda"].named_parameters(),
                         models["cpu"].parameters()):
        diff = (a.detach().cpu() - b.detach()).abs().max().item()
        bar = 1e-5 + lr * 1e-3 * grads["cpu"][n].abs().max().item()
        check(diff <= bar, f"{tag}: params {n} differ by {diff} after the "
              f"step, over 1e-5 + lr x 1e-3 x its gradient max-abs ({bar})")
        if diff / bar > perr:
            perr, worst_leaf = diff / bar, n
    log(f"{tag}: {what}: loss cuda "
        f"{loss['cuda']:.6f} cpu {loss['cpu']:.6f} ({rel:.2e} relative); "
        f"worst grad leaf {worst:.2e} of its max-abs over "
        f"{len(grads['cpu'])} leaves (gradients zero in exact arithmetic: "
        f"{noise:.2e} against the largest gradient {scale:.2e}); params "
        f"after the step at worst {perr:.3f} of their bar ({worst_leaf})")
    return dict(loss_rel=rel, grad_rel=worst, param_of_bar=perr)


def phase_train_cpu(torch):
    """The training step on the card vs on the CPU, same weights; then
    attention dropout on the card."""
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion, \
        _resolve_config
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    cfg = _resolve_config("gpt3-345M", num_hidden_layers=2,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    gm, geng = _train_engine(torch, cfg, "cuda", weight_seed=1)
    cm, ceng = _train_engine(torch, cfg, "cpu")
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    batches = {dev: _batch(cfg, 1, 256, dev) for dev in ("cuda", "cpu")}
    res = _cross_device_step(
        "train-cpu", "2 layers, batch 1 x 256, f32", {"cuda": gm, "cpu": cm},
        {"cuda": geng, "cpu": ceng},
        {d: ([b[0]], [b[1]]) for d, b in batches.items()},
        GPTPretrainingCriterion())

    # attention dropout on the card: every flash launch passes its rate
    # through _drop_args once; record the rates and count the launches
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    rates, drop_args = [], kfa._drop_args

    def recording(seed, dropout_p):
        rates.append(dropout_p)
        return drop_args(seed, dropout_p)

    for w in WRAPPERS:
        w.launches = 0
    gm.config.attention_probs_dropout_prob = 0.1
    kfa._drop_args = recording
    try:
        drop = [geng.train_batch([batches["cuda"][0]],
                                 [batches["cuda"][1]])[0].item()
                for _ in range(2)]
    finally:
        kfa._drop_args = drop_args
        gm.config.attention_probs_dropout_prob = 0.0
    check(all(math.isfinite(x) for x in drop), f"train-cpu: dropout loss "
          f"{drop}")
    want = 2 * cfg.num_hidden_layers
    launches = {w.__name__: w.launches for w in WRAPPERS}
    check(all(launches[n] == want for n in flash)
          and len(rates) == 3 * want and set(rates) == {0.1},
          f"train-cpu: flash launches {launches} with dropout rates "
          f"{sorted(set(rates))} ({len(rates)} launches)")
    log(f"train-cpu: 2 steps with attention dropout 0.1 on cuda: loss "
        f"{drop[0]:.6f}, {drop[1]:.6f}; each flash kernel launched {want} "
        "times, every launch with dropout 0.1")
    return res


# -- ERNIE pretraining and GPT's fused block ----------------------------------

def _ernie_batch(vocab, b, s, device):
    """bench.py run_ernie's batch from numpy seed 0: ids uniform over the
    vocab, 15 % of positions labelled (the rest -100), random NSP labels.
    Returns (inputs, labels) as Engine.train_batch takes them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (b, s))
    lbl = np.where(rng.random((b, s)) < 0.15,
                   rng.integers(0, vocab, (b, s)), -100)
    nsp = rng.integers(0, 2, (b,))
    return ([torch.from_numpy(ids).to(device)],
            [torch.from_numpy(lbl).to(device),
             torch.from_numpy(nsp).to(device)])


def _ernie_engine(torch, cfg, device, amp=None, weight_seed=0,
                  capture=False, guard=None):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.ernie import (ErnieForPretraining,
                                            ErniePretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = ErnieForPretraining(cfg, device=device, generator=seed(
        weight_seed, device=device)).train()
    eng = Engine(model, loss=ErniePretrainingCriterion(),
                 optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 fused_kernel=True), amp_dtype=amp,
                 **({} if capture is None else dict(capture=capture)),
                 **({} if guard is None else dict(guard=guard)))
    return model, eng


def _check_launches(tag, launches, want, steps):
    for name, n in want.items():
        check(launches[name] == n * steps, f"{tag}: {name} launched "
              f"{launches[name]} times in {steps} steps, want {n * steps}")


def phase_ernie(torch):
    """ERNIE-3.0-base pretraining, bench.py's ernie stage on the card."""
    from paddle_tpu_torch.nlp.ernie import _resolve_config
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    b, s, warm, steps = 32, 512, 3, 10
    cfg = _resolve_config("ernie-3.0-base-zh", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    t0 = time.perf_counter()
    model, eng = _ernie_engine(torch, cfg, "cuda", amp=torch.bfloat16)
    inputs, labels = _ernie_batch(cfg.vocab_size, b, s, "cuda")
    torch.cuda.synchronize()
    log(f"ernie: ernie-3.0-base-zh built on cuda in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters, "
        f"{len(model.state_dict())} state-dict keys, "
        f"{cfg.num_hidden_layers} layers, fused_ln); batch {b} x {s}, bf16 "
        "AMP, AdamW(1e-4, weight_decay=0.01, fused_kernel=True)")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warm):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(inputs, labels)[0])
        torch.cuda.synchronize()
        log(f"ernie: warm-up step {i}: {time.perf_counter() - t0:.3f} s, "
            f"loss {losses[-1].item():.4f}")
    opt = eng.optimizer
    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _AdamWWatch() as watch:
        for _ in range(steps):
            losses.append(eng.train_batch(inputs, labels)[0])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    log(f"ernie: kernel launches over {steps} steps: {launches}")
    layers = cfg.num_hidden_layers
    _check_launches("ernie", launches, {
        "fused_add_layer_norm_y_fwd": 2 * layers,
        "fused_add_layer_norm_y_bwd": 2 * layers,
        "fused_add_layer_norm_fwd": 0, "fused_add_layer_norm_bwd": 0,
        "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
        "flash_attention_bwd_dkv": layers}, steps)
    leaves = _check_adamw_route("ernie", model, opt, watch, launches, steps)
    vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in vals), f"ernie: loss {vals}")
    check(vals[-1] < vals[0], f"ernie: loss did not fall: {vals}")
    tok_s = b * s * steps / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"ernie: {steps} steps in {wall:.3f} s = {wall / steps * 1e3:.2f} ms"
        f"/step, {tok_s:.1f} tokens/s; loss {vals[0]:.4f} -> {vals[-1]:.4f};"
        f" max_memory_allocated {peak_gb:.2f} GiB")
    prof = profile_grouped(torch, "ernie", "one training step",
                           lambda: eng.train_batch(inputs, labels),
                           LM_TRAIN_GROUPS)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model, eng, opt
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(11)
    adamw = _adamw_set_case(torch, "ernie-3.0-base", shapes, gen, None)
    torch.cuda.empty_cache()
    return dict(launches=launches, adamw_leaves=leaves, tok_s=tok_s,
                ms_per_step=wall / steps * 1e3, peak_gb=peak_gb,
                losses=vals, adamw=adamw, **prof)


def phase_gpt_fused_ln(torch):
    """gpt3-345M training with fused_ln=True (the fused block's kernels #6
    and #7) at the training slice's shape (phase 7): batch 8 x 1024, bf16
    AMP, 3 steps."""
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    b, s, steps = 8, 1024, 3
    cfg = _resolve_config("gpt3-345M", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    model, eng = _train_engine(torch, cfg, "cuda", amp=torch.bfloat16)
    ids, labels = _batch(cfg, b, s, "cuda")
    for w in WRAPPERS:
        w.launches = 0
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(eng.train_batch([ids], [labels])[0])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {w.__name__: w.launches for w in WRAPPERS}
    log(f"gpt-fused-ln: kernel launches over {steps} steps: {launches}")
    layers = cfg.num_hidden_layers
    _check_launches("gpt-fused-ln", launches, {
        "fused_add_layer_norm_fwd": layers, "fused_add_layer_norm_bwd": layers,
        "fused_add_layer_norm_y_fwd": 0, "fused_add_layer_norm_y_bwd": 0,
        "flash_attention_fwd": layers}, steps)
    vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in vals) and vals[-1] < vals[0],
          f"gpt-fused-ln: loss {vals}")
    log(f"gpt-fused-ln: gpt3-345M, fused_ln, batch {b} x {s}, bf16 AMP: "
        f"steps of {', '.join(f'{x * 1e3:.2f}' for x in secs)} ms (each "
        f"ending in a sync; the first pays first use); loss {vals[0]:.4f} "
        f"-> {vals[-1]:.4f}")
    return dict(launches=launches, losses=vals, step_s=secs)


def phase_ernie_cpu(torch):
    """One ERNIE training step on the card vs on the CPU, same weights:
    2 layers at hidden 768, fused_ln, f32."""
    from paddle_tpu_torch.nlp.ernie import (ErniePretrainingCriterion,
                                            _resolve_config)
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    cfg = _resolve_config("ernie-3.0-base-zh", num_hidden_layers=2,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    gm, geng = _ernie_engine(torch, cfg, "cuda", weight_seed=1)
    cm, ceng = _ernie_engine(torch, cfg, "cpu")
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    before = kln.fused_add_layer_norm_y_bwd.launches
    res = _cross_device_step(
        "ernie-cpu", "2 layers at hidden 768, batch 1 x 256, f32, fused_ln",
        {"cuda": gm, "cpu": cm}, {"cuda": geng, "cpu": ceng},
        {d: _ernie_batch(cfg.vocab_size, 1, 256, d) for d in ("cuda", "cpu")},
        ErniePretrainingCriterion())
    check(kln.fused_add_layer_norm_y_bwd.launches - before
          == 2 * 2 * cfg.num_hidden_layers,
          "ernie-cpu: the cuda side did not run the fused LayerNorm kernels")
    return res


# -- GPT-1.3B training: the wide fused LayerNorm on the main path ------------

def _gpt13b_run(torch, fused_ln, b, s, warm, steps):
    """gpt3-1.3B training on the card, one configuration: warm-up steps,
    then ``steps`` timed steps ending in one sync with the launch counts
    read over them, then one profiled step."""
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    tag = "gpt-1.3b" + (" fused_ln" if fused_ln else "")
    cfg = _resolve_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=fused_ln)
    t0 = time.perf_counter()
    model, eng = _train_engine(torch, cfg, "cuda", amp=torch.bfloat16)
    ids, labels = _batch(cfg, b, s, "cuda")
    torch.cuda.synchronize()
    log(f"{tag}: gpt3-1.3B built on cuda in {time.perf_counter() - t0:.2f} "
        f"s ({sum(p.numel() for p in model.parameters())} parameters, "
        f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads of {cfg.head_dim}); batch {b} x "
        f"{s}, bf16 AMP, AdamW(1e-4, weight_decay=0.01, fused_kernel=True)")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warm):
        t0 = time.perf_counter()
        losses.append(eng.train_batch([ids], [labels])[0])
        torch.cuda.synchronize()
        log(f"{tag}: warm-up step {i}: {time.perf_counter() - t0:.3f} s, "
            f"loss {losses[-1].item():.4f}")
    opt = eng.optimizer
    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _AdamWWatch() as watch:
        for _ in range(steps):
            losses.append(eng.train_batch([ids], [labels])[0])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    log(f"{tag}: kernel launches over {steps} steps: {launches}")
    layers = cfg.num_hidden_layers
    ln = layers if fused_ln else 0
    _check_launches(tag, launches, {
        "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
        "flash_attention_bwd_dkv": layers,
        "fused_add_layer_norm_fwd": ln, "fused_add_layer_norm_bwd": ln,
        "fused_add_layer_norm_y_fwd": 0, "fused_add_layer_norm_y_bwd": 0},
        steps)
    leaves = _check_adamw_route(tag, model, opt, watch, launches, steps)
    vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in vals), f"{tag}: loss {vals}")
    check(vals[-1] < vals[0], f"{tag}: loss did not fall: {vals}")
    tok_s = b * s * steps / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag}: {steps} steps in {wall:.3f} s = {wall / steps * 1e3:.2f} "
        f"ms/step, {tok_s:.1f} tokens/s; loss {vals[0]:.4f} -> "
        f"{vals[-1]:.4f}; max_memory_allocated {peak_gb:.2f} GiB")
    prof = profile_grouped(torch, tag, "one training step",
                           lambda: eng.train_batch([ids], [labels]),
                           LM_TRAIN_GROUPS)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model, eng, opt
    torch.cuda.empty_cache()
    return dict(launches=launches, adamw_leaves=leaves, tok_s=tok_s,
                ms_per_step=wall / steps * 1e3, peak_gb=peak_gb,
                losses=vals, steps=steps, shapes=shapes, **prof)


def phase_gpt13b(torch):
    """GPT-1.3B training, bench.py's gpt-1.3b stage off the TPU (no
    recompute, f32 moments): gpt3-1.3B at full width and depth, seeded
    random weights, dropout 0, batch 4 x 1024, bf16 AMP, fused AdamW
    through Engine; fused_ln off (2 warm-up + 10 timed steps) and on
    (2 + 5)."""
    res = {False: _gpt13b_run(torch, False, 4, 1024, 2, 10),
           True: _gpt13b_run(torch, True, 4, 1024, 2, 5)}
    # #10 over the whole leaf set, once the models are gone
    gen = torch.Generator(device="cuda").manual_seed(13)
    res["adamw"] = _adamw_set_case(torch, "gpt3-1.3B", res[False]["shapes"],
                                   gen, None)
    torch.cuda.empty_cache()
    return res


def phase_gpt13b_cpu(torch):
    """One GPT-1.3B-wide training step on the card vs on the CPU, same
    weights: gpt3-1.3B cut to 2 layers (hidden 2048, 16 heads of 128),
    fused_ln, f32, batch 1 x 128, held to phase 8's bars; the card's side
    runs kernels #6/#7 on rows of 2048 values."""
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion, \
        _resolve_config
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    cfg = _resolve_config("gpt3-1.3B", num_hidden_layers=2,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    gm, geng = _train_engine(torch, cfg, "cuda", weight_seed=1)
    cm, ceng = _train_engine(torch, cfg, "cpu")
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    batches = {dev: _batch(cfg, 1, 128, dev) for dev in ("cuda", "cpu")}
    before = (kln.fused_add_layer_norm_fwd.launches,
              kln.fused_add_layer_norm_bwd.launches)
    res = _cross_device_step(
        "gpt-1.3b-cpu", "2 layers at hidden 2048, batch 1 x 128, f32, "
        "fused_ln", {"cuda": gm, "cpu": cm}, {"cuda": geng, "cpu": ceng},
        {d: ([b[0]], [b[1]]) for d, b in batches.items()},
        GPTPretrainingCriterion())
    # a backward for the gradients and a train step: two of each a layer
    want = 2 * cfg.num_hidden_layers
    got = (kln.fused_add_layer_norm_fwd.launches - before[0],
           kln.fused_add_layer_norm_bwd.launches - before[1])
    check(got == (want, want), f"gpt-1.3b-cpu: kernels #6/#7 launched {got} "
          f"times on the card, want {want} each")
    del gm, geng, cm, ceng
    torch.cuda.empty_cache()
    return res


# -- GPT-1.3B with bench's memory options ------------------------------------

def phase_gpt13b_options(torch):
    """bench.py's gpt-1.3b stage with ``--recompute --fused-qkv
    --chunked-ce 1024 --scan-layers`` against the plain configuration:
    gpt3-1.3B at full width and depth, dropout 0, batch 4 x 1024, bf16 AMP,
    AdamW(1e-4, weight_decay=0.01, fused_kernel=True) (f32 moments: #10
    over every leaf, the scanned model's stacked ones included), both
    Engines eager and resident, the options model from the plain one's
    weights (``load_numpy_state`` stacks the layers and fuses q/k/v). The
    first step's losses from the same weights, then ms a step in turns
    (plain, options, options, plain; 3 steps a turn), each step's peak
    memory above the resident state, and the options run's launches."""
    from paddle_tpu_torch.nlp.convert import load_numpy_state
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    tag = "gpt-1.3b-options"
    b, s, steps = 4, 1024, 3
    base = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfgs = {"plain": _resolve_config("gpt3-1.3B", **base),
            "options": _resolve_config("gpt3-1.3B", recompute=True,
                                       fused_qkv=True, chunked_ce=1024,
                                       scan_layers=True, **base)}
    torch.cuda.empty_cache()
    res, engines, models, resident = {}, {}, {}, {}
    for key, cfg in cfgs.items():
        before = torch.cuda.memory_allocated()
        models[key], engines[key] = _train_engine(torch, cfg, "cuda",
                                                  amp=torch.bfloat16)
        resident[key] = torch.cuda.memory_allocated() - before
    t0 = time.perf_counter()
    load_numpy_state(models["options"], {
        k: v.detach().cpu().numpy()
        for k, v in models["plain"].state_dict().items()})
    log(f"{tag}: the options model takes the plain one's weights "
        f"(layers stacked, q/k/v fused) in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{len(list(models['plain'].parameters()))} leaves plain, "
        f"{len(list(models['options'].parameters()))} scanned")
    ids, labels = _batch(cfgs["plain"], b, s, "cuda")
    first = {key: eng.train_batch([ids], [labels])[0].item()
             for key, eng in engines.items()}
    for key in engines:
        res[key] = dict(resident_gib=resident[key] / 2 ** 30)
    rel = abs(first["options"] - first["plain"]) / abs(first["plain"])
    check(all(math.isfinite(x) for x in first.values()) and rel <= 1e-2,
          f"{tag}: first-step losses from the same weights {first}")
    # optimizer state made by the first steps
    for key in engines:
        res[key]["resident_gib"] += sum(
            t.numel() * t.element_size()
            for st in engines[key].optimizer._state.values()
            for t in st.values()) / 2 ** 30
    turns = {k: [] for k in engines}
    launches = None
    for key in ("plain", "options", "options", "plain"):
        eng = engines[key]
        watch = None
        if key == "options" and launches is None:
            _zero_launches()
            watch = _AdamWWatch().__enter__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        losses = [eng.train_batch([ids], [labels])[0] for _ in range(steps)]
        torch.cuda.synchronize()
        turns[key].append((time.perf_counter() - t0) / steps * 1e3)
        # a step's peak above the resident weights and optimizer state
        res[key].setdefault("step_peak_gib", (
            torch.cuda.max_memory_allocated() - at) / 2 ** 30)
        vals = [x.item() for x in losses]
        check(all(math.isfinite(x) for x in vals)
              and vals[-1] < first[key], f"{tag}: {key}'s losses {vals} "
              f"after {first[key]}")
        if watch is not None:
            watch.__exit__(None, None, None)
            launches = _read_launches()
            layers = cfgs["options"].num_hidden_layers
            _check_launches(tag, launches, {
                "flash_attention_fwd": 2 * layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers,
                "fused_add_layer_norm_fwd": 0,
                "fused_add_layer_norm_bwd": 0}, steps)
            res["adamw_leaves"] = _check_adamw_route(
                tag, models["options"], eng.optimizer, watch, launches,
                steps)
    for key in engines:
        res[key]["ms"] = sum(turns[key]) / len(turns[key])
        res[key]["turns"] = turns[key]
        res[key]["first_loss"] = first[key]
        res[key]["tok_s"] = b * s / res[key]["ms"] * 1e3
    res["launches"] = launches
    res["steps"] = steps
    res["shapes"] = [(n, tuple(p.shape))
                     for n, p in models["options"].named_parameters()]
    log(f"{tag}: first-step loss from the same weights plain "
        f"{first['plain']:.6f}, options {first['options']:.6f} ({rel:.2e} "
        f"relative); ms a step in turns plain {res['plain']['ms']:.3f} "
        f"{[round(x, 3) for x in turns['plain']]} vs options "
        f"{res['options']['ms']:.3f} "
        f"{[round(x, 3) for x in turns['options']]}; a step's peak above "
        f"what was allocated before it plain "
        f"{res['plain']['step_peak_gib']:.2f} GiB, options "
        f"{res['options']['step_peak_gib']:.2f} GiB; resident weights and "
        f"optimizer state plain {res['plain']['resident_gib']:.2f} GiB, "
        f"options {res['options']['resident_gib']:.2f} GiB; the options' "
        f"launches over {steps} steps {launches}")
    del models, engines
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(14)
    res["adamw"] = _adamw_set_case(torch, "gpt3-1.3B scanned",
                                   res["shapes"], gen, None)
    torch.cuda.empty_cache()
    return res


def phase_recompute_dropout(torch):
    """Recompute with dropout inside a CUDA graph: gpt3-345M at dropout
    0.1 (hidden and attention), batch 8 x 1024, bf16 AMP; the eager Engine
    without recompute against the captured one with it, from the same
    weights and generator seed, 3 steps in lockstep (``_graph_pair``: bit
    for bit, else the bars one step at a time). The rerun blocks must see
    the forward's dropout masks and flash seeds: the recording launches
    #1 twice a layer, #3/#4 once, #10 once."""
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    cfgs = {cap: _resolve_config("gpt3-345M", hidden_dropout_prob=0.1,
                                 attention_probs_dropout_prob=0.1,
                                 recompute=cap) for cap in (False, True)}
    ids, labels = _batch(cfgs[False], 8, 1024, "cuda")
    layers = cfgs[False].num_hidden_layers
    r = _graph_pair(
        torch, "recompute-dropout",
        lambda cap: _train_engine(torch, cfgs[cap], "cuda",
                                  amp=torch.bfloat16, capture=cap),
        [ids], [labels], LM_TRAIN_GROUPS, steps=3,
        expect={"flash_attention_fwd": 2 * layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers,
                "fused_adamw_multi_update": 1})
    r.pop("engines")
    gc.collect()
    torch.cuda.empty_cache()
    return r


# -- Llama-1B pretraining: bench.py's llama worker ----------------------------

# llama-1b's attention on the training path: B, H, S, D, kv heads
LLAMA_ATTENTION = (4, 16, 1024, 128, 4)
LLAMA_LAYERS = 22


def phase_llama_flash(torch, flush):
    """#1, #3 and #4 at llama-1b's training attention shape (batch 4, 16
    heads of 128, S = 1024, causal, no dropout), k and v drawn with 4
    heads and expanded to 16 as the model hands them over, held to their
    twins and timed beside SDPA on the same inputs; and a ragged GQA case
    (kv_lens, dropout 0.1)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, h, s, d, kvh = LLAMA_ATTENTION
    rows = [_flash_train_case(torch, b, h, s, s, d, "bfloat16", None, 0.0,
                              gen, flush, timed=True, kv_heads=kvh),
            _flash_train_case(torch, 2, h, 300, 300, d, "bfloat16",
                              [300, 129], 0.1, gen, flush, False,
                              kv_heads=kvh)]
    _log_flash_rows("llama-flash", rows)
    return rows


def _llama_engine(torch, cfg, device, capture=False, weight_seed=0,
                  amp=None):
    """llama through Engine(LlamaPretrainingCriterion, AdamW(1e-4,
    weight_decay=0.01, moment_dtype="bfloat16")), bench.py's llama
    worker's optimizer."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.llama import (LlamaForCausalLM,
                                            LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(cfg, device=device,
                             generator=seed(weight_seed, device=device))
    eng = Engine(model.train(), loss=LlamaPretrainingCriterion(),
                 optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 moment_dtype="bfloat16"),
                 amp_dtype=amp, capture=capture)
    return model, eng


class _RoundWatch:
    """Over a run: the calls of the stochastic bf16 rounding (two a leaf
    a step on the bf16-moment path), the optimizer module's
    ``sround_bf16`` wrapped for the run."""

    def __enter__(self):
        from paddle_tpu_torch.optimizer import optimizer as om
        self._om, self._orig = om, om.sround_bf16
        self.calls = 0

        def counted(*args):
            self.calls += 1
            return self._orig(*args)
        om.sround_bf16 = counted
        return self

    def __exit__(self, *exc):
        self._om.sround_bf16 = self._orig


def _llama_run(torch, tag, recompute, capture, warm, steps):
    """llama-1b training on the card, one configuration: ``warm`` warm-up
    steps, then ``steps`` timed steps ending in one sync. The kernel
    counts are zeroed before the warm-up and read after the timed steps:
    a captured Engine's wrappers count its first (eager) step and its
    recording, and a replay launches the recorded kernels from the graph
    (counted as its nodes). Then one profiled step."""
    from paddle_tpu_torch.nlp.llama import _resolve_config
    cfg = _resolve_config("llama-1b", recompute=recompute)
    b, s = LLAMA_ATTENTION[0], LLAMA_ATTENTION[2]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, eng = _llama_engine(torch, cfg, "cuda", capture=capture,
                               amp=torch.bfloat16)
    ids, labels = _batch(cfg, b, s, "cuda")
    torch.cuda.synchronize()
    leaves = len(list(model.parameters()))
    log(f"{tag}: llama-1b built on cuda in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters in "
        f"{leaves} leaves, {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads of "
        f"{cfg.head_dim} over {cfg.num_key_value_heads} kv heads, FFN "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}); batch {b} x {s}, "
        f"bf16 AMP, recompute={recompute}, AdamW(1e-4, weight_decay=0.01, "
        f"moment_dtype='bfloat16'), "
        f"{'captured' if eng.captures else 'eager'}")
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses = []
    with _RoundWatch() as rw:
        for i in range(warm):
            t0 = time.perf_counter()
            losses.append(eng.train_batch([ids], [labels])[0].clone())
            torch.cuda.synchronize()
            log(f"{tag}: warm-up step {i}: {time.perf_counter() - t0:.3f} s, "
                f"loss {losses[-1].item():.4f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(eng.train_batch([ids], [labels])[0].clone())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _read_launches()
    counted = 2 if eng.captures else warm + steps
    layers = cfg.num_hidden_layers
    fwd = 2 * layers if recompute else layers
    want = {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    _check_launches(tag, launches, want, counted)
    others = {n: c for n, c in launches.items() if c and n not in want}
    check(not others, f"{tag}: other kernels of the port launched {others} "
          "(bf16 moments take the plain update, as in the reference)")
    check(rw.calls == 2 * leaves * counted, f"{tag}: the bf16 rounding ran "
          f"{rw.calls} times, want 2 x {leaves} leaves x {counted} steps")
    recorded = None
    if eng.captures:
        nodes = _graph_node_names(torch, _recording(eng, "train").graph)
        recorded = {w: sum(frag in n for n in nodes)
                    for w, frag in GPT_GRAPH_KERNELS}
        recorded["fused_adamw_multi_update"] = sum("adamw_kernel" in n
                                                   for n in nodes)
        check(recorded == dict(want, fused_adamw_multi_update=0),
              f"{tag}: a replay launches {recorded}, want {want}")
    vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in vals), f"{tag}: loss {vals}")
    check(vals[-1] < vals[0], f"{tag}: loss did not fall: {vals}")
    tok_s = b * s * steps / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag}: {steps} steps in {wall:.3f} s = {wall / steps * 1e3:.2f} "
        f"ms/step, {tok_s:.1f} tokens/s; loss {vals[0]:.4f} -> "
        f"{vals[-1]:.4f}; max_memory_allocated {peak_gb:.2f} GiB; the "
        f"wrappers counted {launches} over {counted} steps that ran them"
        + (f", a replay launches {recorded}" if recorded else "")
        + f"; the bf16 rounding ran {rw.calls} times ({leaves} leaves, "
        f"m and v)")
    prof = profile_grouped(torch, tag, "one training step",
                           lambda: eng.train_batch([ids], [labels]),
                           LM_TRAIN_GROUPS)
    update = None
    if eng.captures:
        # the plain bf16-moment update alone, eagerly over every leaf (zero
        # gradients; the step's scalars as the last step filled them)
        names, params = eng._live()
        grads = [torch.zeros_like(p) for p in params]
        update = profile_grouped(
            torch, f"{tag} update", "the bf16-moment AdamW update alone",
            lambda: eng.optimizer._clip_update(names, params, grads),
            LM_TRAIN_GROUPS)
        del grads
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, counted=counted, recorded=recorded,
                leaves=leaves, tok_s=tok_s, ms_per_step=wall / steps * 1e3,
                peak_gb=peak_gb, losses=vals, steps=steps, update=update,
                **prof)


def phase_llama_train(torch):
    """bench.py's llama worker on the card: llama-1b at full width and
    depth, seeded random weights, batch 4 x 1024, bf16 AMP, recompute,
    AdamW with bf16 moments, through the Engine: the main run captured (2
    warm-up steps, 10 timed), then eager runs with recompute on and off
    for their peak memory, then the eager and the captured Engine from the
    same weights in lockstep (3 steps held to each other) and in turns."""
    from paddle_tpu_torch.nlp.llama import _resolve_config
    res = {"captured": _llama_run(torch, "llama-train", True, None, 2, 10)}
    check(res["captured"]["recorded"] is not None,
          "llama-train: the Engine did not capture")
    res["eager"] = _llama_run(torch, "llama-train eager", True, False, 1, 2)
    res["no_recompute"] = _llama_run(torch, "llama-train recompute off",
                                     False, False, 1, 2)
    log(f"llama-train: peak memory, eager, 3 steps each: recompute on "
        f"{res['eager']['peak_gb']:.2f} GiB, off "
        f"{res['no_recompute']['peak_gb']:.2f} GiB; ms a step "
        f"{res['eager']['ms_per_step']:.2f} vs "
        f"{res['no_recompute']['ms_per_step']:.2f}")
    cfg = _resolve_config("llama-1b", recompute=True)
    ids, labels = _batch(cfg, LLAMA_ATTENTION[0], LLAMA_ATTENTION[2],
                         "cuda")
    layers = cfg.num_hidden_layers
    r = _graph_pair(
        torch, "llama-train graph",
        lambda cap: _llama_engine(torch, cfg, "cuda", capture=cap,
                                  amp=torch.bfloat16),
        [ids], [labels], LM_TRAIN_GROUPS, steps=3,
        expect={"flash_attention_fwd": 2 * layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers})
    r.pop("engines")
    res["graph"] = r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_llama_train_cpu(torch):
    """One llama-1b-wide training step on the card vs on the CPU, same
    weights: llama-1b cut to 2 layers (hidden 2048, 16 heads of 128 over
    4 kv heads, FFN 5632, vocab 32000), f32, recompute, bf16 moments,
    batch 1 x 128, held to phase 8's bars; then the bf16-moment update on
    the card against the CPU from the same noise bits at llama-1b's leaf
    shapes."""
    from paddle_tpu_torch.nlp.llama import (LlamaPretrainingCriterion,
                                            _resolve_config)
    cfg = _resolve_config("llama-1b", num_hidden_layers=2, recompute=True)
    gm, geng = _llama_engine(torch, cfg, "cuda", weight_seed=1)
    cm, ceng = _llama_engine(torch, cfg, "cpu")
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    batches = {dev: _batch(cfg, 1, 128, dev) for dev in ("cuda", "cpu")}
    res = _cross_device_step(
        "llama-train-cpu", "2 layers of llama-1b (hidden 2048, GQA 16:4, "
        "D=128), f32, recompute, bf16 moments, batch 1 x 128",
        {"cuda": gm, "cpu": cm}, {"cuda": geng, "cpu": ceng},
        {d: ([b[0]], [b[1]]) for d, b in batches.items()},
        LlamaPretrainingCriterion(), zero_grads=())
    del gm, geng, cm, ceng
    torch.cuda.empty_cache()
    res["update"] = _bf16_update_cpu(torch)
    return res


# the bf16-moment update on the card against the CPU: parameters within
# this of max(1, |p|); m and v within one bf16 ulp, at most this share of
# them not bit for bit
BF16_UPDATE_TOL = 1e-6
BF16_UPDATE_ULP_SHARE = 1e-4


def _bf16_update_cpu(torch):
    """AdamW(moment_dtype="bfloat16") at step 5 on llama-1b's leaf shapes
    (q, k, gate, down and a norm weight) on the card and on the
    CPU from the same p, g, m, v and rounding noise (drawn with numpy):
    the f32 math is the same ops on both devices and the rounding exact
    integer arithmetic, held to BF16_UPDATE_TOL / BF16_UPDATE_ULP_SHARE."""
    import numpy as np
    from paddle_tpu_torch.optimizer import AdamW
    shapes = {"self_attn.q_proj.weight": (2048, 2048),
              "self_attn.k_proj.weight": (2048, 512),
              "mlp.gate_proj.weight": (2048, 5632),
              "mlp.down_proj.weight": (5632, 2048),
              "input_layernorm.weight": (2048,)}
    rng = np.random.default_rng(5)
    host = {n: dict(p=rng.standard_normal(sh, np.float32),
                    g=rng.standard_normal(sh, np.float32) * 1e-3,
                    m=rng.standard_normal(sh, np.float32) * 1e-3,
                    v=np.abs(rng.standard_normal(sh, np.float32)) * 1e-6,
                    nm=rng.integers(0, 2 ** 16, sh, dtype=np.int32),
                    nv=rng.integers(0, 2 ** 16, sh, dtype=np.int32))
            for n, sh in shapes.items()}
    out = {}
    for dev in ("cuda", "cpu"):
        params = [(n, torch.nn.Parameter(torch.from_numpy(h["p"]).to(dev)))
                  for n, h in host.items()]
        opt = AdamW(1e-4, parameters=params, weight_decay=0.01,
                    moment_dtype="bfloat16")
        for n, p in params:
            h = host[n]
            opt._state[n] = {
                "m": torch.from_numpy(h["m"]).to(dev, torch.bfloat16),
                "v": torch.from_numpy(h["v"]).to(dev, torch.bfloat16)}
            p.grad = torch.from_numpy(h["g"]).to(dev)
        noise = [(torch.from_numpy(host[n]["nm"]).to(dev),
                  torch.from_numpy(host[n]["nv"]).to(dev))
                 for n, _ in params]
        opt.rounding_noise = lambda names, ps, noise=noise: noise
        opt._step_count = 4
        opt.step()
        out[dev] = {n: (p.detach().cpu(), opt._state[n]["m"].cpu(),
                        opt._state[n]["v"].cpu()) for n, p in params}
    perr, not_equal, total, ulps = 0.0, 0, 0, 0
    for n in shapes:
        (pg, mg, vg), (pc, mc, vc) = out["cuda"][n], out["cpu"][n]
        perr = max(perr, ((pg - pc).abs() / pc.abs().clamp_min(1.0))
                   .max().item())
        for a, w in ((mg, mc), (vg, vc)):
            bits = (a.view(torch.int16).int() - w.view(torch.int16).int())
            not_equal += int((bits != 0).sum().item())
            ulps = max(ulps, int(bits.abs().max().item()))
            total += a.numel()
    share = not_equal / total
    check(perr <= BF16_UPDATE_TOL and ulps <= 1
          and share <= BF16_UPDATE_ULP_SHARE,
          f"llama-train-cpu: bf16-moment update cuda vs cpu: params "
          f"{perr} of max(1, |p|), moments {not_equal} of {total} not "
          f"bit for bit, at most {ulps} bf16 ulp apart")
    log(f"llama-train-cpu: the bf16-moment update (step 5, "
        f"{sum(math.prod(s) for s in shapes.values())} values over "
        f"{len(shapes)} leaves of llama-1b's shapes) on the card vs the "
        f"CPU from the same noise bits: params {perr:.2e} of max(1, |p|) "
        f"(bar {BF16_UPDATE_TOL}); m and v {not_equal} of {total} values "
        f"not bit for bit, at most {ulps} bf16 ulp apart (bar: one ulp, a "
        f"share of {BF16_UPDATE_ULP_SHARE})")
    return dict(param_err=perr, moments_not_equal=not_equal,
                moments=total, max_ulps=ulps)


# -- generate(): the dense decode kernel #2, GPT and Llama -------------------

DECODE_KERNELS = ("flash_decode_kernel",)


def _dense_decode_case(torch, b, h, s, d, dtype, lens, gen, flush, timed):
    """Kernel #2 vs its plain twin on one input; timed cases also run
    torch SDPA over the live keys (every row there has the same length)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    dt = getattr(torch, dtype)
    mk = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                    device="cuda").to(dt)
    q, k, v = mk(b, 1, h, d), mk(b, s, h, d), mk(b, s, h, d)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = kfa.flash_decode(q, k, v, lens_t)
    torch.cuda.synchronize()
    ref = kfa.flash_decode_plain(q, k, v, lens_t)
    err, scaled = _err(out, ref)
    check(out.dtype == dt and out.shape == (b, 1, h, d),
          f"dense-decode: output {out.dtype} {tuple(out.shape)}")
    # float16 to 5e-3 of max(1, |twin|); f32 and bf16 absolute, as before
    got = scaled if dtype == "float16" else err
    check(math.isfinite(err) and got <= TOL[dtype],
          f"dense-decode {dtype} b{b} h{h} s{s} d{d} lens{lens}: "
          f"max_abs_err {err} (of max(1, |twin|): {scaled}) over "
          f"{TOL[dtype]}")
    zero = [i for i, n in enumerate(lens) if n == 0]
    check(not out[zero].any().item() if zero else True,
          "dense-decode: a kv_lens-0 row gave a nonzero output")
    # the combine runs in a fixed chunk order: a second call is bit-equal
    out2 = kfa.flash_decode(q, k, v, lens_t)
    torch.cuda.synchronize()
    check(torch.equal(out, out2), f"dense-decode {dtype} b{b} h{h} s{s} "
          f"d{d}: a second call gave another output")
    row = dict(dtype=dtype, b=b, h=h, s=s, d=d, lens=lens, max_abs_err=err,
               scaled_err=scaled, splits=kfa.decode_split(b, h, s))
    if timed:
        row["ms"] = time_ms(torch, lambda: kfa.flash_decode(q, k, v, lens_t),
                            flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: kfa.flash_decode_plain(
            q, k, v, lens_t), flush=flush)
        n = lens[0]
        check(all(x == n for x in lens), "dense-decode: timed rows differ")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :n], v[:, :n]))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(torch, lambda: sdpa(qt, kt, vt),
                                    flush=flush)
        keys = sum(lens)
        esz = q.element_size()
        bytes_moved = (2 * b * h * d * esz            # q read, out written
                       + 2 * h * keys * d * esz       # live K and V rows
                       + b * 4)                       # kv_lens
        row["bound_ms"], row["bound_by"] = bound(
            bytes_moved, 4 * h * d * keys,
            F32_FLOPS if dtype == "float32" else BF16_FLOPS)
    return row


def _check_one_decode_kernel(torch):
    """Four flash_decode calls at Llama-2-7B's shape put exactly one
    kernel each on the device."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    q = torch.randn(4, 1, 32, 128, device="cuda").bfloat16()
    k = torch.randn(4, 576, 32, 128, device="cuda").bfloat16()
    lens = torch.tensor([576, 300, 1, 0], dtype=torch.int32, device="cuda")
    _check_one_kernel(torch, "dense-decode",
                      lambda: kfa.flash_decode(q, k, k, lens),
                      DECODE_KERNELS)


def phase_dense_decode(torch, flush):
    """Kernel #2 at the generate slice's shapes: GPT's (B=8, H=16, D=64)
    and Llama-2-7B's (B=4, H=32, D=128), f32 and bf16, over a 576-key
    cache with ragged lengths (1, S, one not a multiple of 128, 0); D=256
    and a cache shorter than one chunk; timed where every row has all 576
    keys (the last decode step)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    s = 576
    rows = []
    for dtype in ("float32", "bfloat16"):
        rows.append(_dense_decode_case(
            torch, 8, 16, s, 64, dtype, [1, s, 300, 0, 513, 128, 64, 575],
            gen, flush, False))
        rows.append(_dense_decode_case(torch, 4, 32, s, 128, dtype,
                                       [s, 1, 0, 333], gen, flush, False))
        rows.append(_dense_decode_case(torch, 2, 4, 200, 256, dtype,
                                       [200, 77], gen, flush, False))
        rows.append(_dense_decode_case(torch, 3, 2, 5, 64, dtype,
                                       [5, 0, 2], gen, flush, False))
    # a long cache and a small batch: 16 chunks a row, the in-launch
    # combine over them
    rows.append(_dense_decode_case(torch, 1, 32, 4096, 128, "bfloat16",
                                   [4001], gen, flush, False))
    rows.append(_dense_decode_case(torch, 2, 32, 4096, 128, "float32",
                                   [4096, 1111], gen, flush, False))
    rows.append(_dense_decode_case(torch, 8, 16, s, 64, "float32", [s] * 8,
                                   gen, flush, True))
    rows.append(_dense_decode_case(torch, 4, 32, s, 128, "bfloat16", [s] * 4,
                                   gen, flush, True))
    _check_one_decode_kernel(torch)
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} sdpa_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        log(f"dense-decode: {r['dtype']} b{r['b']} h{r['h']} s{r['s']} "
            f"d{r['d']} lens{r['lens']} (splits, chunk) {r['splits']} "
            f"max_abs_err {r['max_abs_err']:.3e}{extra}")
    return rows


# llama-1b's serving decode shape (bench.py's worker_serve off smoke, batch
# 32): hkv 4, G 4, D 128, pages of 128 keys, 2 pages a slot (max_seq 256)
LLAMA1B_DECODE = dict(b=32, hkv=4, g=4, d=128, ps=128, mp=2)
# the ladder's prompt lengths (bench.py:652)
SERVE_PROMPTS = (96, 120, 64, 100)


def phase_fp16_decode(torch, flush):
    """#5 and #2 in float16. #5 at llama-1b's serving decode shape (B=32,
    Hkv=4, G=4, D=128, ps=128, MP=2; the ladder's prompts 64 tokens into
    decode): float16 q over f32, bf16 and int8 pools and over float16
    pools, beside f32 q over f32 pools (the f32 rungs' call), timed; then
    float16 q over each pool at G 1, 4 and 6 with lens 0, one key, a page
    edge and the full table, and at D 64 and 256; the split at llama-1b's
    shape must be one wave of blocks for every pool type (blocks a call
    against cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs). #2
    with a float16 cache at llama2-7b's (B=4, H=32, D=128) and GPT's
    (B=8, H=16, D=64) decode shapes over 576 keys, ragged and timed where
    every row has all 576, at D=256 and over a 4096-key cache. Each case
    is held against its twin within 5e-3 of max(1, |twin|) and repeats
    bit for bit; timed cases report held ms, the twin's, the bound and
    (#2) SDPA in float16."""
    kpd = _paged_module()
    gen = torch.Generator(device="cuda").manual_seed(24)
    ld = LLAMA1B_DECODE
    b, hkv, g, d, ps, mp = (ld[k] for k in ("b", "hkv", "g", "d", "ps",
                                            "mp"))
    lens = [n + 64 for n in SERVE_PROMPTS] * (b // len(SERVE_PROMPTS))
    paged = []
    for pool, qd in (("float32", "float32"), ("float32", "float16"),
                     ("bfloat16", "float16"), ("int8", "float16"),
                     ("float16", "float16")):
        paged.append(_decode_case(torch, b, hkv, g, d, ps, mp, pool, lens,
                                  gen, flush, timed=True, q_dtype=qd))
    edge = [0, 256, 1, 128, 129, 255, 0, 17]
    for pool in ("float32", "bfloat16", "int8", "float16"):
        for gg in (1, 4, 6):
            paged.append(_decode_case(torch, 8, hkv, gg, d, ps, mp, pool,
                                      edge, gen, flush, False,
                                      q_dtype="float16"))
        for dd, gg in ((64, 6), (256, 1)):
            paged.append(_decode_case(torch, 4, 2, gg, dd, 16, 32, pool,
                                      [512, 0, 77, 300], gen, flush, False,
                                      q_dtype="float16"))
    splits, ppc = kpd.paged_decode_split(b, hkv, g, mp, ps)
    blocks = splits * hkv * -(-g // 4) * b
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    residency = {}
    for pool in ("float32", "bfloat16", "int8", "float16"):
        r = kpd.paged_decode_residency(getattr(torch, pool), d, g, ppc)
        residency[pool] = r
        check(blocks <= r["blocks_per_sm"] * sms,
              f"fp16-decode: {blocks} blocks a call at llama-1b's shape "
              f"over {pool} pools outgrow one wave ({r})")
        log(f"fp16-decode: #5 at llama-1b's shape, {pool} pools: (splits, "
            f"pages a chunk) ({splits}, {ppc}), {blocks} blocks a call; "
            f"{r['blocks_per_sm']} resident an SM x {sms} SMs (registers "
            f"{r['registers']}, shared memory {r['smem']} B, spill "
            f"{r['spill_bytes']} B): one wave")
    dense = []
    for bb, h, dd, ragged in ((4, 32, 128, [576, 1, 0, 333]),
                              (8, 16, 64, [1, 576, 300, 0, 513, 128, 64,
                                           575])):
        dense.append(_dense_decode_case(torch, bb, h, 576, dd, "float16",
                                        ragged, gen, flush, False))
        dense.append(_dense_decode_case(torch, bb, h, 576, dd, "float16",
                                        [576] * bb, gen, flush, True))
    dense.append(_dense_decode_case(torch, 2, 4, 200, 256, "float16",
                                    [200, 77], gen, flush, False))
    dense.append(_dense_decode_case(torch, 2, 32, 4096, 128, "float16",
                                    [4001, 1111], gen, flush, False))
    for r in paged:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} (unheld {unheld(r['ms']):.4f}) plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}): {r['bound_ms'] / r['ms']:.3f} of the bound")
        log(f"fp16-decode: #5 {r['q_dtype']} q, {r['dtype']} pools, b{r['b']}"
            f" hkv{r['hkv']} g{r['g']} d{r['d']} ps{r['ps']} mp{r['mp']} "
            f"(splits, pages a chunk) {r['split']} max_abs_err "
            f"{r['max_abs_err']:.3e} (of max(1, |twin|) "
            f"{r['scaled_err']:.3e}){extra}")
    for r in dense:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} (unheld {unheld(r['ms']):.4f}) plain_ms "
            f"{r['plain_ms']:.4f} sdpa_ms {r['library_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
        log(f"fp16-decode: #2 float16 b{r['b']} h{r['h']} s{r['s']} "
            f"d{r['d']} lens{r['lens']} (splits, chunk) {r['splits']} "
            f"max_abs_err {r['max_abs_err']:.3e} (of max(1, |twin|) "
            f"{r['scaled_err']:.3e}){extra}")
    return dict(paged=paged, dense=dense, residency=residency,
                blocks=blocks)


def _prompts(vocab, b, s, seed=0):
    import numpy as np
    import torch
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return torch.from_numpy(ids).to("cuda")


def _check_stream(tag, out, ids, new, vocab, eos=None, pad=0):
    """Shape, prompt kept, tokens in range; after a row's first eos only
    pad. Returns the number of rows that emitted eos."""
    b, s0 = ids.shape
    check(tuple(out.shape) == (b, s0 + new) and out.dtype == ids.dtype,
          f"{tag}: output {tuple(out.shape)} {out.dtype}")
    check(bool((out[:, :s0] == ids).all()), f"{tag}: the prompt changed")
    toks = out[:, s0:]
    check(bool(((toks >= 0) & (toks < vocab)).all()),
          f"{tag}: a token out of [0, {vocab})")
    if eos is None:
        return 0
    hit = toks == eos
    after = hit.int().cumsum(dim=1) - hit.int() > 0   # past the first eos
    check(bool((toks[after] == pad).all()),
          f"{tag}: a token other than pad {pad} after eos {eos}")
    return int(hit.any(dim=1).sum().item())


def _timed_generate(torch, model, ids, new, **kw):
    """(out, wall seconds, prefill seconds, launches of every wrapper):
    one generate() call between syncs, with the counts set to 0 just
    before it; then the prefill alone (the same static-cache forward
    generate() starts with), for the decode steps' share of the wall."""
    from paddle_tpu_torch.framework import convert_dtype
    from paddle_tpu_torch.nlp import generation as gen
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    with torch.no_grad():
        cache = gen._alloc_cache(model.config, ids.shape[0],
                                 ids.shape[1] + new,
                                 convert_dtype(kw.get("cache_dtype",
                                                      "float32")), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen._cache_fwd(model, ids, cache, 0)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
    return out, wall, prefill, launches


def _report_generate(tag, what, ids, new, wall, prefill, rows=None):
    b = ids.shape[0] if rows is None else rows
    step_ms = (wall - prefill) / new * 1e3
    tok_s = ids.shape[0] * new / wall
    log(f"{tag}: {what}: {wall:.3f} s for {ids.shape[0]} x {new} new tokens "
        f"({tok_s:.1f} tokens/s end to end); prefill {prefill * 1e3:.2f} ms "
        f"(run alone), decode {step_ms:.3f} ms a step over {b} rows = "
        f"{b * 1e3 / step_ms:.1f} rows x steps/s")
    return dict(wall_s=wall, prefill_ms=prefill * 1e3, step_ms=step_ms,
                tok_s=tok_s)


def profile_decode_steps(torch, tag, model, ids, cache_dtype, steps=8):
    """``steps`` greedy decode steps (the forward generate() runs each step,
    after an unprofiled prefill) under torch.profiler: the device's busy
    share of their wall time and kernel #2's share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.framework import convert_dtype
    from paddle_tpu_torch.nlp import generation as gen
    b, s0 = ids.shape
    with torch.no_grad():
        cache = gen._alloc_cache(model.config, b, s0 + steps,
                                 convert_dtype(cache_dtype), "cuda")
        last, cache = gen._cache_fwd(model, ids, cache, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(steps):
                nxt = torch.argmax(last, dim=-1).to(ids.dtype)
                last, cache = gen._cache_fwd(model, nxt[:, None], cache,
                                             s0 + t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    busy = sum(a.self_device_time_total for a in rows) / 1e6
    if busy <= 0:
        log(f"{tag}: the profiler recorded no device time; decode busy "
            "share not measured")
        return dict(busy_share=None, decode_share=None)
    dec = sum(a.self_device_time_total for a in rows
              if any(n in a.key for n in DECODE_KERNELS)) / 1e6
    launches = sum(a.count for a in rows) / steps
    log(f"{tag}: profile of {steps} decode steps: wall {wall * 1e3:.3f} ms "
        f"under the profiler ({wall / steps * 1e3:.3f} ms a step, "
        f"{launches:.0f} device kernels a step), device busy "
        f"{busy * 1e3:.3f} ms = {busy / wall:.3f} of it; kernel #2 "
        f"{dec * 1e3:.3f} ms = {dec / busy:.3f} of the device time")
    for a in rows[:6]:
        log(f"{tag}:   {a.self_device_time_total / 1e3:9.3f} ms  "
            f"x{a.count:<5d} {a.key[:90]}")
    return dict(busy_share=busy / wall, decode_share=dec / busy,
                step_ms_profiled=wall / steps * 1e3,
                kernels_per_step=launches)


def phase_generate_gpt(torch):
    """gpt3-345M generate() at full width and depth, f32 weights from seed
    0: greedy with an f32 and a bf16 cache (batch 8 x 512, 64 new tokens),
    beam search (num_beams=4, batch 2) and sampling (top_k=50, top_p=0.9,
    repetition_penalty=1.2, eos)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    cfg = _resolve_config("gpt3-345M")
    model = GPTForCausalLM(cfg, device="cuda", generator=seed(0)).eval()
    v, layers, new = cfg.vocab_size, cfg.num_hidden_layers, 64
    ids = _prompts(v, 8, 512)
    for cache in ("float32", "bfloat16"):             # first use, full shape
        model.generate(ids, max_new_tokens=2, cache_dtype=cache)
    res = {}
    outs = {}
    for cache in ("float32", "bfloat16"):
        out, wall, pre, launches = _timed_generate(
            torch, model, ids, new, decode_strategy="greedy_search",
            cache_dtype=cache)
        _check_stream(f"generate-gpt {cache}", out, ids, new, v)
        check(launches["flash_decode"] == layers * new,
              f"generate-gpt {cache}: flash_decode launched "
              f"{launches['flash_decode']} times, want {layers} x {new}")
        others = {n: c for n, c in launches.items()
                  if c and n != "flash_decode"}
        check(not others, f"generate-gpt {cache}: other kernels {others}")
        res[cache] = _report_generate(
            "generate-gpt", f"greedy, {cache} cache, flash_decode x "
            f"{launches['flash_decode']}", ids, new, wall, pre)
        res[cache]["launches"] = launches
        outs[cache] = out
    agree = (outs["float32"][:, 512:] == outs["bfloat16"][:, 512:]).float()
    log(f"generate-gpt: greedy tokens of the bf16 cache equal the f32 "
        f"cache's at {agree.mean().item():.3f} of positions (first tokens "
        f"{agree[:, 0].mean().item():.3f})")
    greedy = outs["float32"]

    bids = ids[:2]
    beam = model.generate(bids, max_new_tokens=new, num_beams=4)
    _check_stream("generate-gpt beam", beam, bids, new, v)
    # eos: a token the best beam of row 0 emits early without one
    eos = int(beam[0, 512 + 3])
    out, wall, pre, launches = _timed_generate(
        torch, model, bids, new, num_beams=4, eos_token_id=eos,
        pad_token_id=0)
    fin = _check_stream("generate-gpt beam", out, bids, new, v, eos, 0)
    check(launches["flash_decode"] == layers * new,
          f"generate-gpt beam: flash_decode x {launches['flash_decode']}")
    res["beam"] = _report_generate(
        "generate-gpt", f"beam search, 4 beams, eos {eos} ({fin} of 2 rows "
        "ended)", bids, new, wall, pre, rows=8)

    eos = int(greedy[1, 512 + 1])
    out, wall, pre, launches = _timed_generate(
        torch, model, ids, new, top_k=50, top_p=0.9,
        repetition_penalty=1.2, eos_token_id=eos, pad_token_id=0, seed=0)
    fin = _check_stream("generate-gpt sampling", out, ids, new, v, eos, 0)
    check(launches["flash_decode"] == layers * new,
          f"generate-gpt sampling: flash_decode x {launches['flash_decode']}")
    check(not bool((out[:, 512:] == greedy[:, 512:]).all()),
          "generate-gpt sampling: the sampled stream is the greedy one")
    res["sampling"] = _report_generate(
        "generate-gpt", f"sampling top_k=50 top_p=0.9 rep 1.2, eos {eos} "
        f"({fin} of 8 rows ended)", ids, new, wall, pre)
    res["profile"] = profile_decode_steps(torch, "generate-gpt", model, ids,
                                          "float32")
    return res


def phase_generate_llama(torch):
    """llama2-7b generate() at full width and depth (32 layers, 32 heads,
    D=128, FFN 11008), bf16 weights drawn on the card from seed 0, bf16
    cache, batch 4 x 512, 64 new tokens, greedy: every decode step runs
    kernel #2 in each layer."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.llama import LlamaForCausalLM, _resolve_config
    cfg = _resolve_config("llama2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"generate-llama: llama2-7b built on cuda in "
        f"{time.perf_counter() - t0:.2f} s ({n_params} parameters, bf16, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
    new, layers = 64, cfg.num_hidden_layers
    ids = _prompts(cfg.vocab_size, 4, 512)
    model.generate(ids, max_new_tokens=2, cache_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    out, wall, pre, launches = _timed_generate(
        torch, model, ids, new, cache_dtype="bfloat16")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_stream("generate-llama", out, ids, new, cfg.vocab_size)
    check(launches["flash_decode"] == layers * new,
          f"generate-llama: flash_decode launched {launches['flash_decode']}"
          f" times, want {layers} x {new}")
    res = _report_generate("generate-llama", f"llama2-7b greedy, bf16 "
                           f"cache, flash_decode x "
                           f"{launches['flash_decode']}", ids, new, wall, pre)
    log(f"generate-llama: max_memory_allocated {peak:.2f} GiB; a decode "
        f"step's weights alone take {2 * n_params / HBM_BYTES_PER_S * 1e3:.3f}"
        " ms at 3.35 TB/s")
    res.update(launches=launches, peak_gb=peak, params=n_params,
               profile=profile_decode_steps(torch, "generate-llama", model,
                                            ids, "bfloat16"))
    return res


def phase_generate_llama_gqa(torch):
    """llama-1b (GQA 16:4) generate() at full width, bf16, batch 4 x 256,
    32 new tokens, greedy: the grouped plain path, which launches no
    kernel #2, as in the reference."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.llama import LlamaForCausalLM, _resolve_config
    cfg = _resolve_config("llama-1b")
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=seed(0)).eval()
    ids = _prompts(cfg.vocab_size, 4, 256)
    model.generate(ids, max_new_tokens=2, cache_dtype="bfloat16")
    out, wall, pre, launches = _timed_generate(
        torch, model, ids, 32, cache_dtype="bfloat16")
    _check_stream("generate-gqa", out, ids, 32, cfg.vocab_size)
    check(launches["flash_decode"] == 0,
          f"generate-gqa: flash_decode launched {launches['flash_decode']} "
          "times on the grouped path")
    return _report_generate("generate-gqa", "llama-1b (GQA 16:4) greedy, "
                            "bf16 cache, flash_decode x 0", ids, 32, wall,
                            pre)


def phase_generate_cpu(torch):
    """The same weights on the card and on the CPU, cut to 2 layers at full
    width, f32: gpt3-345M and llama2-7b, prompts 2 x 32, 8 new tokens;
    greedy tokens equal and the prefill logits within 1e-3."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp import generation as gen
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM
    from paddle_tpu_torch.nlp.gpt import _resolve_config as gpt_config
    from paddle_tpu_torch.nlp.llama import LlamaForCausalLM
    from paddle_tpu_torch.nlp.llama import _resolve_config as llama_config
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    res = {}
    for name, cls, cfg in (
            ("gpt3-345M", GPTForCausalLM,
             gpt_config("gpt3-345M", num_hidden_layers=2)),
            ("llama2-7b", LlamaForCausalLM,
             llama_config("llama2-7b", num_hidden_layers=2))):
        gm = cls(cfg, device="cuda", generator=seed(1)).eval()
        cm = cls(cfg, device="cpu", generator=seed(1, device="cpu")).eval()
        cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
        ids = _prompts(cfg.vocab_size, 2, 32, seed=5)
        logits = {}
        with torch.no_grad():
            for dev, m in (("cuda", gm), ("cpu", cm)):
                cache = gen._alloc_cache(cfg, 2, 40, torch.float32, dev)
                logits[dev] = m(ids.to(dev), cache=cache,
                                cache_index=0)[0].float().cpu()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(math.isfinite(err) and err <= 1e-3,
              f"generate-cpu {name}: prefill logits cuda vs cpu "
              f"max_abs_err {err}")
        before = kfa.flash_decode.launches
        toks = {"cuda": gm.generate(ids, max_new_tokens=8).cpu()}
        check(kfa.flash_decode.launches - before
              == cfg.num_hidden_layers * 8,
              f"generate-cpu {name}: the cuda side did not run kernel #2")
        toks["cpu"] = cm.generate(ids.cpu(), max_new_tokens=8)
        check(bool((toks["cuda"] == toks["cpu"]).all()),
              f"generate-cpu {name}: greedy tokens differ: cuda "
              f"{toks['cuda'][:, 32:].tolist()} cpu "
              f"{toks['cpu'][:, 32:].tolist()}")
        log(f"generate-cpu: {name}, 2 layers at full width, f32: prefill "
            f"logits cuda vs cpu max_abs_err {err:.3e}; greedy tokens equal "
            f"({toks['cpu'][:, 32:].tolist()})")
        res[name] = err
        del gm, cm
    return res



# bench.py's worker_serve off smoke: pages of 128 keys, 256 keys a slot, 128
# new tokens, 16 decode steps a dispatch
LLAMA_ENGINE = dict(page_size=128, max_seq_len=256, steps_per_dispatch=16)
LLAMA_NEW = 128
# a top-two logit gap at or below this is a tie that f32 round-off may
# break either way (the f32 paths agree to ~1e-5 on these logits)
GREEDY_TIE = 1e-4


def _first_split(a, b):
    """The first index where two token lists differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _greedy_equal(torch, tag, model, prompt, got, want):
    """Greedy streams ``got`` and ``want`` of ``prompt`` equal, or equal up
    to a step whose top-two logits (``model`` teacher-forced over the
    prompt and the shared tokens, no cache) lie within GREEDY_TIE: a tie.
    Returns the step of a tie, or None."""
    at = _first_split(got, want)
    if at is None:
        return None
    ids = torch.tensor([list(prompt) + list(want[:at])], device=next(
        model.parameters()).device)
    with torch.no_grad():
        top = model(ids)[0, -1].float().topk(2).values
    gap = float(top[0] - top[1])
    check(gap <= GREEDY_TIE, f"{tag}: greedy tokens differ at step {at} "
          f"({got[at]} vs {want[at]}) where the top two logits lie "
          f"{gap:.3e} apart")
    log(f"{tag}: greedy tokens differ at step {at} ({got[at]} vs "
        f"{want[at]}), a tie: the top two logits {gap:.3e} apart")
    return at


class _QDtypes:
    """Over a run: the q dtype of every call of ops.attention's paged
    decode (what the serving step hands the kernel's wrapper)."""

    def __enter__(self):
        from paddle_tpu_torch.ops import attention
        self.seen, self._mod = {}, attention
        self._fn = fn = attention.paged_flash_decode

        def spy(q, *args, **kw):
            self.seen[str(q.dtype)] = self.seen.get(str(q.dtype), 0) + 1
            return fn(q, *args, **kw)
        attention.paged_flash_decode = spy
        return self

    def __exit__(self, *exc):
        self._mod.paged_flash_decode = self._fn


def _serve_rung(torch, tag, model, batch, cache, rng):
    """One rung of the ladder as bench.py's worker_serve runs it: an engine
    of ``batch`` slots over a ``cache`` pool, a warm-up wave of ``batch``
    requests, then, with the counts set to 0, a timed wave of 2 x
    ``batch`` (prompts drawn from ``rng`` in turn). The warm-up wave stops
    after one dispatch (``steps_per_dispatch`` tokens, not 128): the port
    compiles nothing, and one dispatch meets every first use a wave has
    (each prefill bucket, the decode step at the rung's batch). #5 must launch once a
    layer a decode step and #1 once a layer a prefill, no other kernel and
    no twin; every page comes back. -> (row, prompts, token lists,
    engine)."""
    import numpy as np
    from paddle_tpu_torch.nlp.serving import ServingEngine
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    vocab, layers = model.config.vocab_size, model.config.num_hidden_layers
    eng = ServingEngine(model, device="cuda", max_slots=batch,
                        cache_dtype=cache, **LLAMA_ENGINE)

    def wave(n, new=LLAMA_NEW):
        prompts = [rng.integers(0, vocab, (SERVE_PROMPTS[i % 4],))
                   for i in range(n)]
        ids = [eng.submit(p, new) for p in prompts]
        res = {r["id"]: r for r in eng.run_to_completion()}
        return prompts, [res[i] for i in ids]

    wave(batch, eng.steps_per_dispatch)
    eng.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in WRAPPERS:
        w.launches = 0
    with _TwinWatch() as tw, _QDtypes() as qd:
        t0 = time.perf_counter()
        prompts, res = wave(2 * batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = eng.decode_dispatches * eng.steps_per_dispatch
    check(launches["paged_flash_decode"] == layers * steps,
          f"{tag}: #5 launched {launches['paged_flash_decode']} times over "
          f"{steps} decode steps of {layers} layers")
    check(launches["flash_attention_fwd"] == layers * 2 * batch,
          f"{tag}: #1 launched {launches['flash_attention_fwd']} times over "
          f"{2 * batch} prefills of {layers} layers")
    others = {n: c for n, c in launches.items() if c and n not in (
        "paged_flash_decode", "flash_attention_fwd")}
    check(not others and not tw.calls, f"{tag}: other kernels {others} or "
          f"twins {tw.calls} on the serving path")
    check(sum(qd.seen.values()) == launches["paged_flash_decode"],
          f"{tag}: paged decode calls {qd.seen} vs launches")
    check(eng.free_page_count == eng.num_pages - 1,
          f"{tag}: free pages {eng.free_page_count} != {eng.num_pages - 1}")
    toks = [r["tokens"] for r in res]
    for t in toks:
        check(len(t) == LLAMA_NEW and all(0 <= x < vocab for x in t),
              f"{tag}: bad token stream {t[:8]}...")
    ttft = sorted(r["ttft_s"] for r in res)
    row = dict(batch=batch, cache_dtype=cache,
               model_dtype=str(next(model.parameters()).dtype)[6:],
               q_dtypes=qd.seen, launches=launches,
               decode_steps=steps, dispatches=eng.decode_dispatches,
               tok_s=eng.decode_tokens / eng.decode_seconds,
               step_ms=eng.decode_seconds / steps * 1e3,
               wall_tok_s=sum(len(t) for t in toks) / wall, wall_s=wall,
               ttft_p50_ms=float(np.percentile(ttft, 50)) * 1e3,
               ttft_max_ms=ttft[-1] * 1e3, peak_gb=peak,
               pool_gb=sum(t.numel() * t.element_size()
                           for layer in eng._pages for t in layer
                           if t is not None) / 2 ** 30)
    log(f"{tag}: {2 * batch} requests x {LLAMA_NEW} tokens in {wall:.3f} s "
        f"({row['wall_tok_s']:.1f} tokens/s wall); decode "
        f"{eng.decode_tokens} tokens in {eng.decode_seconds:.3f} s over "
        f"{steps} steps = {row['tok_s']:.1f} tokens/s, {row['step_ms']:.3f}"
        f" ms a step; TTFT p50 {row['ttft_p50_ms']:.2f} ms (max "
        f"{row['ttft_max_ms']:.2f}); #5 x {launches['paged_flash_decode']} "
        f"(q {qd.seen}), #1 x {launches['flash_attention_fwd']}; peak "
        f"{peak:.2f} GiB, pools {row['pool_gb']:.3f} GiB")
    return row, prompts, toks, eng


def phase_llama_serve(torch):
    """bench.py --serve --serve-model llama off smoke, on the port: llama-1b
    (vocab 32000, hidden 2048, 22 layers, 16 heads of 128 over 4 kv heads,
    FFN 5632) at full width and depth, f32 weights from seed 0 on the card,
    through ServingEngine(page_size=128, max_seq_len=256,
    steps_per_dispatch=16) at batch 1, 8 and 32 over f32, bf16 and int8
    caches (bench's flash rungs; prompts 96/120/64/100 drawn from numpy
    seed 0 in turn, 128 new tokens, a warm-up wave of batch requests, then
    a timed wave of 2 x batch): #5 22 launches a decode step, #1 22 a
    prefill. With the f32 cache, the first requests' greedy tokens equal
    the same model's generate() on the card (a tie excepted). Then the
    model cast to float16 at batch 32 over each cache (#5 with float16 q;
    #1 in float16). One batch-32 dispatch profiled in f32 and in
    float16 (f32 caches)."""
    import numpy as np
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.llama import LlamaForCausalLM, _resolve_config
    cfg = _resolve_config("llama-1b")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", generator=seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"llama-serve: llama-1b built on cuda in "
        f"{time.perf_counter() - t0:.2f} s ({n_params} parameters, f32, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
    rng = np.random.default_rng(0)
    rows, ties = [], []
    # the f32 rungs' requests held against generate(): the first at batch
    # 1 and 8; at 32 the first and the third (prompts of 96 and 64 keys:
    # prefill buckets 128 and 64)
    vs_generate = {1: (0,), 8: (0,), 32: (0, 2)}
    for batch in (1, 8, 32):
        for cache in ("float32", "bfloat16", "int8"):
            tag = f"llama-serve b{batch}/{cache}"
            row, prompts, toks, eng = _serve_rung(torch, tag, model, batch,
                                                  cache, rng)
            rows.append(row)
            if cache == "float32":
                for i in vs_generate[batch]:
                    ids = torch.from_numpy(prompts[i][None]).to("cuda")
                    want = model.generate(ids, max_new_tokens=LLAMA_NEW)[
                        0, len(prompts[i]):].tolist()
                    at = _greedy_equal(torch, f"{tag} request {i}", model,
                                       prompts[i], toks[i], want)
                    ties.append((tag, i, at))
                log(f"{tag}: greedy tokens of request(s) "
                    f"{vs_generate[batch]} equal generate()'s on the card "
                    f"({sum(t[2] is not None for t in ties)} ties so far)")
            if batch == 32 and cache == "float32":
                busy = {"float32": profile_decode(torch, eng, prompts)}
            del eng
            torch.cuda.empty_cache()
    model.half()
    for cache in ("float32", "bfloat16", "int8"):
        row, prompts, _, eng = _serve_rung(
            torch, f"llama-serve f16 b32/{cache}", model, 32, cache, rng)
        check(set(row["q_dtypes"]) == {"torch.float16"},
              f"llama-serve f16: #5 took q of {row['q_dtypes']}")
        rows.append(row)
        if cache == "float32":
            busy["float16"] = profile_decode(torch, eng, prompts)
        del eng
        torch.cuda.empty_cache()
    f16_launches = sum(r["launches"]["paged_flash_decode"] for r in rows
                       if r["model_dtype"] == "float16")
    f32_launches = sum(r["launches"]["paged_flash_decode"] for r in rows
                       if r["model_dtype"] == "float32")
    del model
    torch.cuda.empty_cache()
    return dict(rows=rows, busy_share=busy, ties=ties,
                launches={"paged_flash_decode": f32_launches},
                f16_launches={"paged_flash_decode": f16_launches})


def phase_llama_serve_cpu(torch):
    """llama-1b cut to 2 layers at full width, f32, the same weights on the
    card and on the CPU: the engine's prefill (bucket 128, kv_lens) last-row
    logits within 1e-3, then 2 requests (prompts 96 and 64) served with 16
    greedy tokens each on both devices: tokens equal (a tie excepted)."""
    import numpy as np
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.llama import LlamaForCausalLM, _resolve_config
    from paddle_tpu_torch.nlp.serving import ServingEngine
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    cfg = _resolve_config("llama-1b", num_hidden_layers=2)
    gm = LlamaForCausalLM(cfg, device="cuda", generator=seed(2)).eval()
    cm = LlamaForCausalLM(cfg, device="cpu",
                          generator=seed(2, device="cpu")).eval()
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (96, 64)]
    errs = []
    with torch.no_grad():
        for p in prompts:
            x = np.zeros((1, 128), np.int64)
            x[0, :len(p)] = p
            rows = [m(torch.from_numpy(x).to(dev), kv_lens=torch.tensor(
                [len(p)], dtype=torch.int32, device=dev))[0, len(p) - 1]
                .float().cpu() for m, dev in ((gm, "cuda"), (cm, "cpu"))]
            err = (rows[0] - rows[1]).abs().max().item()
            check(math.isfinite(err) and err <= 1e-3,
                  f"llama-serve-cpu: prefill last-row logits cuda vs cpu "
                  f"max_abs_err {err}")
            errs.append(err)
    kw = dict(LLAMA_ENGINE, max_slots=2)
    for w in WRAPPERS:
        w.launches = 0
    got = ServingEngine(gm, device="cuda", **kw).generate(prompts, 16)
    launches = {w.__name__: w.launches for w in WRAPPERS}
    check(launches["paged_flash_decode"] > 0
          and launches["flash_attention_fwd"] == 2 * 2,
          f"llama-serve-cpu: the card's engine launched {launches}")
    want = ServingEngine(cm, device="cpu", **kw).generate(prompts, 16)
    ties = [_greedy_equal(torch, f"llama-serve-cpu request {i}", cm, p, g, w)
            for i, (p, g, w) in enumerate(zip(prompts, got, want))]
    log(f"llama-serve-cpu: llama-1b, 2 layers at full width, f32: prefill "
        f"last-row logits cuda vs cpu max_abs_err {max(errs):.3e}; greedy "
        f"tokens equal (ties at {ties}); #5 x "
        f"{launches['paged_flash_decode']} on the card")
    del gm, cm
    return dict(prefill_err=max(errs), ties=ties)


def phase_generate_fp16(torch):
    """llama2-7b generate() with a float16 cache: weights drawn in float16
    on the card from seed 0, batch 4 x 512, 64 new tokens, greedy: every
    decode step of every layer runs #2 in float16 (32 x 64 launches, no
    other kernel of the port); against the same model with an f32 cache
    (#2 in f32) the first tokens equal and the agreement logged; tokens/s,
    ms a step, peak memory and 8 profiled steps."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.llama import LlamaForCausalLM, _resolve_config
    cfg = _resolve_config("llama2-7b")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float16,
                             generator=seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"generate-fp16: llama2-7b built on cuda in "
        f"{time.perf_counter() - t0:.2f} s ({n_params} parameters, float16)")
    new, layers = 64, cfg.num_hidden_layers
    ids = _prompts(cfg.vocab_size, 4, 512)
    model.generate(ids, max_new_tokens=2, cache_dtype="float16")
    torch.cuda.reset_peak_memory_stats()
    with _TwinWatch() as tw:
        out, wall, pre, launches = _timed_generate(
            torch, model, ids, new, cache_dtype="float16")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_stream("generate-fp16", out, ids, new, cfg.vocab_size)
    check(launches["flash_decode"] == layers * new,
          f"generate-fp16: flash_decode launched {launches['flash_decode']}"
          f" times, want {layers} x {new}")
    others = {n: c for n, c in launches.items() if c and n != "flash_decode"}
    check(not others and not tw.calls, f"generate-fp16: other kernels "
          f"{others} or twins {tw.calls}")
    res = _report_generate("generate-fp16", f"llama2-7b float16 greedy, "
                           f"float16 cache, flash_decode x "
                           f"{launches['flash_decode']}", ids, new, wall, pre)
    ref = model.generate(ids, max_new_tokens=new, cache_dtype="float32")
    agree = (out[:, 512:] == ref[:, 512:]).float()
    check(bool(agree[:, 0].all()), f"generate-fp16: first tokens "
          f"{out[:, 512].tolist()} vs the f32 cache's {ref[:, 512].tolist()}")
    log(f"generate-fp16: greedy tokens of the float16 cache equal the f32 "
        f"cache's at {agree.mean().item():.3f} of positions (first tokens "
        f"equal); max_memory_allocated {peak:.2f} GiB")
    res.update(launches=launches, peak_gb=peak, agree=agree.mean().item(),
               profile=profile_decode_steps(torch, "generate-fp16", model,
                                            ids, "float16"))
    del model
    return res


# -- ResNet-50 serving: the fused 1x1-conv + BN + ReLU kernel #11 ------------

CONV_KERNELS = ("conv_bn_act_bf16_kernel", "conv_bn_act_tf32_kernel")
# (M, Cin, Cout, residual, launches in one forward): the 32 launches of one
# ResNet-50 forward at batch 256 x 224 px (M = N*H*W; stride 2 sits on
# conv2, so a stage's first conv1 runs at the previous stage's resolution)
SERVE_SHAPES = (
    (802816, 64, 64, False, 1), (802816, 256, 64, False, 2),
    (802816, 64, 256, True, 3), (802816, 256, 128, False, 1),
    (200704, 512, 128, False, 3), (200704, 128, 512, True, 4),
    (200704, 512, 256, False, 1), (50176, 1024, 256, False, 5),
    (50176, 256, 1024, True, 6), (50176, 1024, 512, False, 1),
    (12544, 2048, 512, False, 2), (12544, 512, 2048, True, 3))


def _conv_case(torch, m, cin, cout, res, relu, dtype, gen, flush, timed,
               offset=0):
    """Kernel #11 vs its plain twin on one input (x ``offset`` values
    into its buffer); timed cases also run the cuBLAS product of the same
    operands alone."""
    from paddle_tpu_torch.ops.kernels import conv_bn_act as kcb
    dt = getattr(torch, dtype)
    x2 = torch.randn(m * cin + offset, generator=gen,
                     device="cuda").to(dt)[offset:].view(m, cin)
    w = (torch.randn(cin, cout, generator=gen, device="cuda")
         / math.sqrt(cin)).to(dt)
    scale = 1.0 + 0.1 * torch.randn(cout, generator=gen, device="cuda")
    shift = 0.1 * torch.randn(cout, generator=gen, device="cuda")
    r2 = torch.randn(m, cout, generator=gen, device="cuda").to(dt) \
        if res else None
    out = kcb.fused_conv1x1_bn_act(x2, w, scale, shift, r2, relu)
    torch.cuda.synchronize()
    ref = kcb.conv_bn_act_plain(x2, w, scale, shift, r2, relu)
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    scaled = (diff / ref.float().abs().clamp_min(1.0)).max().item()
    check(out.dtype == dt and out.shape == (m, cout),
          f"conv-bn-act: output {out.dtype} {tuple(out.shape)}")
    row = dict(dtype=dtype, m=m, cin=cin, cout=cout, res=res, relu=relu,
               offset=offset, max_abs_err=err, scaled_err=scaled)
    if dtype == "float16":
        row["ulps"] = f16_ulps(out, ref)
        check(row["ulps"] <= F16_ULPS, f"conv-bn-act float16 m{m} "
              f"{cin}->{cout} res={res} relu={relu}: {row['ulps']} float16 "
              f"ulps of max(1, |twin|) > {F16_ULPS}")
    else:
        check(math.isfinite(scaled) and scaled <= TOL[dtype],
              f"conv-bn-act {dtype} m{m} {cin}->{cout} res={res} "
              f"relu={relu}: error {scaled} of max(1, |twin|) > "
              f"{TOL[dtype]}")
    del ref, diff
    if dtype == "float32":
        exact = _conv_exact(x2, w, scale, shift, r2, relu)
        row["exact_err"] = ((out.double() - exact).abs()
                            / exact.abs().clamp_min(1.0)).max().item()
        check(row["exact_err"] <= F32_EXACT_TOL,
              f"conv-bn-act float32 m{m} {cin}->{cout} res={res} "
              f"relu={relu}: {row['exact_err']} of max(1, |y|) from the "
              f"float64 product > {F32_EXACT_TOL}")
        del exact
    if timed:
        row["ms"] = time_ms(torch, lambda: kcb.fused_conv1x1_bn_act(
            x2, w, scale, shift, r2, relu), flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: kcb.conv_bn_act_plain(
            x2, w, scale, shift, r2, relu), flush=flush)
        row["gemm_ms"] = time_ms(torch, lambda: torch.matmul(x2, w),
                                 flush=flush)
        row.update(conv_bound(m, cin, cout, res, dtype))
    return row


def _conv_exact(x2, w, scale, shift, r2, relu=True):
    """#11's function in float64 on the card."""
    y = (x2.double() @ w.double()) * scale.double() + shift.double()
    if r2 is not None:
        y += r2.double()
    return y.clamp_min(0) if relu else y


def conv_bound(m, cin, cout, res, dtype):
    """#11's least time at one shape: x, w, scale, shift (and res) read
    once, y written once; the product's 2 M Cin Cout FLOPs at the bf16
    tensor-core peak, or in f32 at the f32 bar as fwd_bound reckons it
    (3xTF32: three TF32 products at the TF32 peak), with the CUDA cores'
    f32 bound beside it (``cuda_core_bound_ms``). float16 moves bf16's
    bytes at bf16's dense tensor-core peak."""
    esz = 4 if dtype == "float32" else 2
    bytes_moved = ((m * cin + cin * cout + m * cout * (2 if res else 1))
                   * esz + 2 * cout * 4)
    flops = 2 * m * cin * cout
    out = dict(bound_bytes_ms=bytes_moved / HBM_BYTES_PER_S * 1e3)
    if dtype != "float32":
        out["bound_ops_ms"] = flops / BF16_FLOPS * 1e3
        out["bound_ms"], out["bound_by"] = bound(bytes_moved, flops,
                                                 BF16_FLOPS)
    else:
        out["bound_ops_ms"] = 3 * flops / TF32_FLOPS * 1e3
        out["bound_ms"], out["bound_by"] = bound(bytes_moved, 3 * flops,
                                                 peak=TF32_FLOPS)
        out["cuda_core_bound_ms"] = bound(bytes_moved, flops)[0]
    return out


def phase_conv_bn_act(torch, flush):
    """Kernel #11 against its twin: the 12 serve-path shapes in bf16 (timed,
    with the GEMM alone beside them), four of them in f32, residual and
    ReLU on and off, and ragged M, Cin and Cout; every f32 case also
    against the float64 product at F32_EXACT_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for m, cin, cout, res, _ in SERVE_SHAPES:
        rows.append(_conv_case(torch, m, cin, cout, res, True, "bfloat16",
                               gen, flush, True))
    for m, cin, cout, res, _ in (SERVE_SHAPES[0], SERVE_SHAPES[5],
                                 SERVE_SHAPES[8], SERVE_SHAPES[11]):
        rows.append(_conv_case(torch, m, cin, cout, res, True, "float32",
                               gen, flush, False))
    for dtype in ("float32", "bfloat16"):
        for res, relu in ((False, False), (True, False), (True, True),
                          (False, True)):
            rows.append(_conv_case(torch, 50176, 256, 1024, res, relu, dtype,
                                   gen, flush, False))
        for m, cin, cout in ((1, 64, 64), (7, 256, 64), (1000, 3, 64),
                             (333, 64, 1), (1000, 100, 70), (129, 8, 9),
                             (12545, 512, 2048), (7, 3, 1)):
            for res in (False, True):
                rows.append(_conv_case(torch, m, cin, cout, res, True, dtype,
                                       gen, flush, False))
        # x off a 16-byte boundary: the scalar copies of the x tile
        for m, cin, cout in ((1000, 64, 70), (257, 512, 256)):
            rows.append(_conv_case(torch, m, cin, cout, True, True, dtype,
                                   gen, flush, False, offset=1))
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}) plain_ms {r['plain_ms']:.4f} GEMM alone "
            f"(computes less than #11) {r['gemm_ms']:.4f}")
        log(f"conv-bn-act: {r['dtype']} M={r['m']} {r['cin']}->{r['cout']} "
            f"res={r['res']} relu={r['relu']} offset={r['offset']} "
            f"max_abs_err "
            f"{r['max_abs_err']:.3e} (of max(1, |twin|): "
            f"{r['scaled_err']:.3e})"
            + (f"; from float64 {r['exact_err']:.3e} of max(1, |y|)"
               if "exact_err" in r else "") + extra)
    timed = [r for r in rows if "ms" in r]
    total = _shape_sum(timed, [n for *_, n in SERVE_SHAPES])
    train = _shape_sum(timed, [TRAIN_SHAPES.get(i, 0)
                               for i in range(len(SERVE_SHAPES))])
    for what, t in (("the 32 launches of one ResNet-50 serve forward",
                     total),
                    ("the 17 launches of one training forward", train)):
        log(f"conv-bn-act: {what} (batch 256, 224 px, bf16): kernel "
            f"{t['ms']:.4f} ms against a bound of {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms']:.3f} of it); twin "
            f"{t['plain_ms']:.4f} ms; GEMM alone (computes less than #11) "
            f"{t['gemm_ms']:.4f} ms")
    return dict(rows=rows, total=total, train_total=train)


def _shape_sum(timed, counts):
    """The timed rows of SERVE_SHAPES summed with a launch count each."""
    total = {key: sum(r[key] * n for r, n in zip(timed, counts))
             for key in ("ms", "plain_ms", "gemm_ms", "bound_ms",
                         "bound_bytes_ms", "bound_ops_ms",
                         "cuda_core_bound_ms") if key in timed[0]}
    for key in ("ms", "plain_ms", "gemm_ms"):
        total[key] = Timing(total[key])
        total[key].unheld = sum(unheld(r[key]) * n
                                for r, n in zip(timed, counts))
    total["bound_by"] = ("bytes" if total["bound_bytes_ms"]
                         >= total["bound_ops_ms"] else "operations")
    return total


def _resnet_input(torch, b, hw, dtype, seed=0):
    import numpy as np
    x = np.random.default_rng(seed).standard_normal((b, 3, hw, hw))
    return torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)


def profile_forward(torch, tag, model, x):
    """One forward under torch.profiler: the device's busy share of its
    wall time, kernel #11's share of the device time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    busy = sum(a.self_device_time_total for a in rows) / 1e6
    if busy <= 0:
        log(f"{tag}: the profiler recorded no device time; busy share not "
            "measured")
        return dict(busy_share=None, conv_share=None)
    own = sum(a.self_device_time_total for a in rows
              if any(n in a.key for n in CONV_KERNELS)) / 1e6
    log(f"{tag}: one forward profiled: wall {wall * 1e3:.3f} ms under the "
        f"profiler, {sum(a.count for a in rows)} device kernels, device busy "
        f"{busy * 1e3:.3f} ms = {busy / wall:.3f} of it; kernel #11 "
        f"{own * 1e3:.3f} ms = {own / busy:.3f} of the device time")
    for a in rows[:8]:
        log(f"{tag}:   {a.self_device_time_total / 1e3:9.3f} ms  "
            f"x{a.count:<5d} {a.key[:90]}")
    return dict(busy_share=busy / wall, conv_share=own / busy,
                device_ms=busy * 1e3)


def _randomize_bn(torch, model, seed):
    """Draw every BatchNorm's statistics and affine parameters from
    ``seed``: at their initial values (0, 1, 1, 0) a folded BatchNorm and
    the plain one do the same arithmetic, which would hide a wrong fold."""
    from paddle_tpu_torch.nn import BatchNorm2D
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2D):
                c = m._mean.shape[0]
                m.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m._mean.copy_(0.1 * torch.randn(c, generator=gen))
                m._variance.copy_(0.5 + torch.rand(c, generator=gen))
    return model


def _logits_close(tag, got, want, tol=1e-3):
    """Logits within tol of the reference's max-abs, top-1 equal."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= tol * max(scale, 1e-30),
          f"{tag}: logits max_abs_err {err} > {tol} x max-abs {scale}")
    top = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(top == 1.0, f"{tag}: top-1 equal at only {top} of the rows")
    return err, scale


def phase_resnet_serve(torch):
    """resnet50 (NHWC, fused_bottleneck) at full depth and width, weights
    from seed 0, eval, cast to bf16 with its running statistics, as
    bench.py's _resnet_serve: batch 256 x 3 x 224 x 224 from numpy seed 0
    under inference_mode, 3 warm-up and 10 timed forwards with one sync;
    32 launches of #11 a forward; then bench.py's --fold-bn (the pairs
    folded in f32 by incubate.fuse_conv_bn, then bf16): 53 pairs, no
    launch of #11, its images/s; then the same weights in f32 (BatchNorm
    statistics drawn at random), fused against the unfused NHWC model at
    batch 64 x 224 px, and the unfused model folded against itself."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate import fuse_conv_bn
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.ops.kernels import conv_bn_act as kcb
    from paddle_tpu_torch.vision.models import resnet50
    b, hw, steps = 256, 224, 10
    torch.cuda.reset_peak_memory_stats()
    model = resnet50(num_classes=1000, layout="NHWC", fused_bottleneck=True,
                     device="cuda", generator=seed(0)).eval()
    model.to(torch.bfloat16)
    check(model.layer1[0].bn1._mean.dtype == torch.bfloat16,
          "resnet-serve: the running statistics were not cast to bf16")
    x = _resnet_input(torch, b, hw, torch.bfloat16)
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        for w in WRAPPERS:
            w.launches = 0
        logits = model(x)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in WRAPPERS}
        check(launches["fused_conv1x1_bn_act"] == 32,
              f"resnet-serve: #11 launched {launches['fused_conv1x1_bn_act']}"
              " times in one forward, want 32")
        others = {n: c for n, c in launches.items()
                  if c and n != "fused_conv1x1_bn_act"}
        check(not others, f"resnet-serve: other kernels launched {others}")
        check(logits.shape == (b, 1000) and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()),
              f"resnet-serve: logits {logits.dtype} {tuple(logits.shape)} "
              "not finite bf16 [256, 1000]")
        kcb.fused_conv1x1_bn_act.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            logits = model(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(kcb.fused_conv1x1_bn_act.launches == 32 * steps,
              f"resnet-serve: #11 x {kcb.fused_conv1x1_bn_act.launches} over "
              f"{steps} forwards, want {32 * steps}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(launches=launches, images_per_s=b * steps / wall,
               ms_per_forward=wall / steps * 1e3, peak_gib=peak)
    log(f"resnet-serve: resnet50 NHWC fused, bf16, batch {b} x {hw} px: "
        f"{res['images_per_s']:.1f} images/s, {res['ms_per_forward']:.3f} "
        f"ms a forward ({steps} forwards, one sync), #11 x 32 a forward, "
        f"peak {peak:.2f} GiB")
    res["profile"] = profile_forward(torch, "resnet-serve", model, x)
    del model, logits
    torch.cuda.empty_cache()

    # bench.py --fold-bn: the 53 pairs folded in f32, then the cast to
    # bf16; a folded convolution carries a bias, so #11's route declines it
    fm = resnet50(num_classes=1000, layout="NHWC", fused_bottleneck=True,
                  device="cuda", generator=seed(0)).eval()
    fm, folded = fuse_conv_bn(fm)
    check(folded == 53, f"resnet-serve: fuse_conv_bn folded {folded} "
          "pairs, want 53")
    fm.to(torch.bfloat16)
    flog, _, fips, fms = _serve(torch, "resnet-serve folded", fm, x, {})
    check(bool(torch.isfinite(flog).all()) and flog.shape == (b, 1000),
          "resnet-serve folded: logits not finite [256, 1000]")
    res["fold"] = dict(pairs=folded, images_per_s=fips, ms_per_forward=fms,
                       ratio=fips / res["images_per_s"])
    log(f"resnet-serve: --fold-bn ({folded} pairs folded in f32, then "
        f"bf16): {fips:.1f} images/s, {fms:.3f} ms a forward, no launch of "
        f"#11 (the folded convolutions carry a bias); "
        f"{res['fold']['ratio']:.3f} of the fused route's "
        f"{res['images_per_s']:.1f}")
    del fm, flog, x
    torch.cuda.empty_cache()

    # f32: the kernel's f32 path against the plain NHWC stack, the same
    # weights with random BatchNorm statistics
    fb = 64
    fused = resnet50(num_classes=1000, layout="NHWC", fused_bottleneck=True,
                     device="cuda", generator=seed(0)).eval()
    _randomize_bn(torch, fused, 20)
    plain = resnet50(num_classes=1000, layout="NHWC", device="cuda",
                     generator=seed(1)).eval()
    plain.load_state_dict(fused.state_dict())
    x = _resnet_input(torch, fb, hw, torch.float32)
    with torch.inference_mode():
        kcb.fused_conv1x1_bn_act.launches = 0
        yf = fused(x)
        check(kcb.fused_conv1x1_bn_act.launches == 32,
              "resnet-serve f32: the fused model did not launch #11 32 times")
        yp = plain(x)
        check(kcb.fused_conv1x1_bn_act.launches == 32,
              "resnet-serve f32: the unfused model launched #11")
    err, scale = _logits_close("resnet-serve f32 fused vs unfused", yf, yp)
    log(f"resnet-serve: f32, batch {fb} x {hw} px, fused NHWC vs unfused "
        f"NHWC: logits max_abs_err {err:.3e} of max-abs {scale:.3e}; top-1 "
        "equal")
    res["f32_err"] = err / scale
    fuse_conv_bn(plain)
    with torch.inference_mode():
        yfold = plain(x)
    ferr, _ = _logits_close("resnet-serve f32 folded vs unfolded", yfold,
                            yp, tol=1e-4)
    log(f"resnet-serve: f32, batch {fb}, the unfused model folded: logits "
        f"max_abs_err {ferr:.3e} from unfolded (of max-abs {scale:.3e}); "
        "top-1 equal")
    return res


def phase_resnet_cpu(torch):
    """resnet50, fused NHWC, f32, batch 2 x 3 x 64 x 64: the same weights
    (BatchNorm statistics drawn at random) on the card (kernel #11) and on
    the CPU (its twin)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.kernels import conv_bn_act as kcb
    from paddle_tpu_torch.vision.models import resnet50
    gm = resnet50(layout="NHWC", fused_bottleneck=True, device="cuda",
                  generator=seed(2)).eval()
    _randomize_bn(torch, gm, 21)
    cm = resnet50(layout="NHWC", fused_bottleneck=True, device="cpu",
                  generator=seed(3, device="cpu")).eval()
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    x = _resnet_input(torch, 2, 64, torch.float32, seed=5)
    with torch.inference_mode():
        kcb.fused_conv1x1_bn_act.launches = 0
        yg = gm(x)
        check(kcb.fused_conv1x1_bn_act.launches == 32,
              "resnet-cpu: the cuda side did not launch #11 32 times")
        yc = cm(x.cpu())
        check(kcb.fused_conv1x1_bn_act.launches == 32,
              "resnet-cpu: the CPU side counted a launch")
    err, scale = _logits_close("resnet-cpu cuda vs cpu", yg, yc)
    log(f"resnet-cpu: resnet50 fused NHWC, f32, batch 2 x 64 px: logits cuda "
        f"vs cpu max_abs_err {err:.3e} of max-abs {scale:.3e}; argmax equal")
    return err / scale


# -- ResNet-50 training: #11 on the train-mode fused bottleneck -------------

# SERVE_SHAPES rows a training forward launches #11 at, with their counts:
# the route fuses only where Cin <= Cout under batch statistics, which is
# layer1.0's conv1 (64 -> 64) and the sixteen conv3s
TRAIN_SHAPES = {0: 1, 2: 3, 5: 4, 8: 6, 11: 3}
# device kernels of a training step, grouped by name (first match wins)
TRAIN_GROUPS = (
    ("#11", ("conv_bn_act",)),
    ("cuDNN convolutions", ("fprop", "dgrad", "wgrad", "implicit", "conv",
                            "winograd", "cudnn", "nhwc", "nchw")),
    ("f32/bf16 GEMMs (#11's backward, the Gram products, fc)",
     ("gemm", "cutlass", "cublas")),
    ("Momentum (foreach)", ("multi_tensor_apply",)),
    ("the loss", ("softmax", "nll", "gather", "scatter")),
    ("pools", ("pool",)),
    ("elementwise and reductions (eager BatchNorm, ReLU, residual, casts)",
     ("elementwise", "reduce", "copy", "fill", "cat", "index")),
)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _resnet_train_engine(torch, device, fused=True, s2d=False, amp=None,
                         weight_seed=0, capture=False, guard=None,
                         model=None):
    """bench.py's build_resnet_engine on the port: resnet50(num_classes=
    1000, NHWC, fused_bottleneck, s2d_stem).train() (or ``model``),
    Momentum(0.1, 0.9), Engine(model, CrossEntropyLoss(), opt, amp_dtype,
    guard), eager unless ``capture``."""
    from paddle_tpu_torch import nn, seed
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    if model is None:
        model = resnet50(num_classes=1000, layout="NHWC",
                         fused_bottleneck=fused, s2d_stem=s2d, device=device,
                         generator=seed(weight_seed, device=device)).train()
    opt = Momentum(0.1, momentum=0.9, parameters=model.named_parameters())
    return model, Engine(model, nn.CrossEntropyLoss(), opt, amp_dtype=amp,
                         guard=guard, capture=capture)


def _resnet_train_batch(torch, b, hw, device="cuda", seed=0):
    """run_resnet's batch: x from numpy's standard_normal, labels from
    integers(0, 1000), one generator seeded ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 3, hw, hw)).astype(np.float32)
    y = rng.integers(0, 1000, (b,))
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(y).to(device))


def profile_resnet_train(torch, tag, eng, x, y):
    """One training step under torch.profiler: busy time over wall time,
    the host's kernel launches, and the device time grouped by kind."""
    return profile_grouped(torch, tag, "one training step",
                           lambda: eng.train_batch([x], [y]), TRAIN_GROUPS)


def _busy_union(events, device_type):
    """Seconds during which at least one device kernel ran: the union of
    the kernels' intervals (None when the events carry none). Where
    kernels overlap (cuDNN's own streams) the union is below their sum."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == device_type)
    union, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e6 if spans else None


def profile_grouped(torch, tag, what, run, groups_spec):
    """``run()`` once under torch.profiler: busy time over wall time (the
    union of the kernels' intervals), the host's kernel launches, and the
    device time grouped by kernel name (``groups_spec``: (group, name
    patterns), the first match wins), each group's share of the kernels'
    summed time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    rows = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    launches = sum(a.count for a in avgs if a.key in LAUNCH_CALLS)
    graphs = sum(a.count for a in avgs if a.key in GRAPH_LAUNCH_CALLS)
    busy = sum(a.self_device_time_total for a in rows) / 1e6
    if busy <= 0:
        log(f"{tag}: the profiler recorded no device time; busy share not "
            "measured")
        return dict(busy_share=None, launch_calls=launches,
                    graph_launches=graphs)
    groups = {name: [0.0, 0] for name, _ in groups_spec}
    groups["other"] = [0.0, 0]
    for a in rows:
        key = a.key.lower()
        name = next((g for g, pats in groups_spec
                     if any(p in key for p in pats)), "other")
        groups[name][0] += a.self_device_time_total / 1e3
        groups[name][1] += a.count
    summed = busy
    busy = _busy_union(prof.events(), DeviceType.CUDA) or summed
    log(f"{tag}: {what} profiled: wall {wall * 1e3:.3f} ms "
        f"under the profiler, device busy {busy * 1e3:.3f} ms = "
        f"{busy / wall:.3f} of it (kernel times summed {summed * 1e3:.3f} "
        f"ms); {launches} kernel launches by the host, {graphs} graph "
        f"launches, {sum(a.count for a in rows)} device kernels")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        if n:
            log(f"{tag}:   {ms:9.3f} ms = {ms / (summed * 1e3):.3f}  "
                f"x{n:<5d} {name}")
    for a in rows[:10]:
        log(f"{tag}:   {a.self_device_time_total / 1e3:9.3f} ms  "
            f"x{a.count:<5d} {a.key[:90]}")
    return dict(busy_share=busy / wall, device_ms=busy * 1e3,
                summed_ms=summed * 1e3, launch_calls=launches,
                graph_launches=graphs,
                groups={n: g[0] for n, g in groups.items()})


def _resnet_train_run(torch, tag, fused, s2d, warm, steps):
    """One configuration of resnet50 training on the card at batch 256 x
    224 px, bf16 AMP: ``warm`` steps, then ``steps`` timed steps ending in
    one sync with the launch counts read over them, then one profiled
    step."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    b, hw = 256, 224
    t0 = time.perf_counter()
    model, eng = _resnet_train_engine(torch, "cuda", fused, s2d, "bfloat16")
    x, y = _resnet_train_batch(torch, b, hw)
    stats0 = {n: t.clone() for n, t in model.named_buffers()}
    torch.cuda.synchronize()
    log(f"{tag}: resnet50 built on cuda in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters; NHWC, "
        f"fused_bottleneck={fused}, s2d_stem={s2d}); batch {b} x 3 x {hw} x "
        f"{hw}, bf16 AMP, Momentum(0.1, 0.9)")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warm):
        t0 = time.perf_counter()
        losses.append(eng.train_batch([x], [y])[0])
        torch.cuda.synchronize()
        log(f"{tag}: warm-up step {i}: {time.perf_counter() - t0:.3f} s, "
            f"loss {losses[-1].item():.4f}")
    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(eng.train_batch([x], [y])[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    want = 17 if fused else 0
    check(launches["fused_conv1x1_bn_act"] == want * steps,
          f"{tag}: #11 launched {launches['fused_conv1x1_bn_act']} times in "
          f"{steps} steps, want {want * steps}")
    others = {n: c for n, c in launches.items()
              if c and n != "fused_conv1x1_bn_act"}
    check(not others, f"{tag}: other kernels of the port launched {others}")
    vals = [v.item() for v in losses]
    check(all(math.isfinite(v) for v in vals), f"{tag}: loss {vals}")
    bufs = dict(model.named_buffers())
    check(all(t.dtype == torch.float32 for t in bufs.values()),
              f"{tag}: running statistics not f32")
    moved = sum(not torch.equal(bufs[n], t) for n, t in stats0.items())
    check(moved == len(stats0), f"{tag}: {len(stats0) - moved} running "
          "statistics did not move")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          f"{tag}: parameters not f32")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(launches=launches, images_per_s=b * steps / wall,
               ms_per_step=wall / steps * 1e3, peak_gib=peak, losses=vals,
               steps=steps)
    log(f"{tag}: {steps} steps in {wall:.3f} s = {res['ms_per_step']:.3f} "
        f"ms/step, {res['images_per_s']:.1f} images/s; #11 x "
        f"{want} a step, no other kernel of the port; loss {vals[0]:.4f} "
        f"-> {vals[-1]:.4f}; {len(stats0)} f32 running statistics moved; "
        f"max_memory_allocated {peak:.2f} GiB")
    res.update(profile_resnet_train(torch, tag, eng, x, y))
    del model, eng, x, y
    torch.cuda.empty_cache()
    return res


def phase_resnet_train(torch):
    """bench.py's resnet50 stage on the card at batch 256 x 224 px, bf16
    AMP: fused_bottleneck (3 warm-up + 10 timed steps), unfused (2 + 5),
    and the fused model with s2d_stem (3 + 2: a step after one warm-up
    still runs up to twice as long as a settled one)."""
    res = {"fused": _resnet_train_run(torch, "resnet-train", True, False,
                                      3, 10),
           "unfused": _resnet_train_run(torch, "resnet-train unfused", False,
                                        False, 2, 5),
           "s2d": _resnet_train_run(torch, "resnet-train s2d_stem", True,
                                    True, 3, 2)}
    log("resnet-train: images/s fused {:.1f}, unfused {:.1f}, fused with "
        "s2d_stem {:.1f} (7x7 stem: the fused run)".format(
            *(res[k]["images_per_s"] for k in ("fused", "unfused", "s2d"))))
    return res


def phase_resnet_train_cpu(torch):
    """resnet50 fused NHWC, f32, Momentum(0.1, 0.9), batch 32 x 3 x 96 x
    96 (layer4 at 3 x 3): the same weights (BatchNorm statistics and affine
    parameters drawn at random) train 3 steps on the card (#11) and on the
    CPU (its twin), the card's side starting each step from the CPU's
    parameters, statistics and velocity.

    Held to section 2's training-step bars where they are defined: the
    loss 1e-4 relative, the running statistics 1e-4 of their max-abs, the
    classifier's velocity 1e-3 of its max-abs and its parameters 1e-5. A
    leaf below a ReLU gets another gradient wherever a ReLU input lies
    within the f32 forward's error of 0 on one device (the kink), so its
    update is held by its relative L2 norm (5e-2) and the per-element
    reading is reported. Both devices' first gradients (the velocity after
    step 1) are also read against a float64 step of the unfused model on
    the CPU, which shows how far f32 itself sits from the exact one: the
    card's median and worst leaf may sit at most 1.5x as far as the CPU
    twin's."""
    from paddle_tpu_torch import nn, seed
    from paddle_tpu_torch.ops.kernels import conv_bn_act as kcb
    from paddle_tpu_torch.vision.models import resnet50
    b, hw, steps = 32, 96, 3
    gm, geng = _resnet_train_engine(torch, "cuda", weight_seed=4)
    _randomize_bn(torch, gm, 22)
    cm, ceng = _resnet_train_engine(torch, "cpu", weight_seed=5)
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    gx, gy = _resnet_train_batch(torch, b, hw, "cuda", seed=6)
    cx, cy = gx.cpu(), gy.cpu()
    gopt, copt = geng.optimizer, ceng.optimizer
    exact = resnet50(num_classes=1000, layout="NHWC", device="cpu",
                     dtype=torch.float64,
                     generator=seed(7, device="cpu")).train()
    exact.load_state_dict(cm.state_dict())
    nn.CrossEntropyLoss()(exact(cx.double()), cy).backward()
    g64 = {n: p.grad for n, p in exact.named_parameters()}
    del exact
    worst = dict(loss=0.0, stats=0.0, fc_vel=0.0, fc_param=0.0, update=0.0)
    elem_ok, leaves = 0, 0
    kcb.fused_conv1x1_bn_act.launches = 0
    for step in range(1, steps + 1):
        before = {k: v.clone() for k, v in cm.state_dict().items()}
        lg = geng.train_batch([gx], [gy])[0].item()
        lc = ceng.train_batch([cx], [cy])[0].item()
        rel = abs(lg - lc) / abs(lc)
        check(math.isfinite(rel) and rel <= 1e-4, f"resnet-train-cpu step "
              f"{step}: loss cuda {lg} vs cpu {lc} ({rel} relative)")
        worst["loss"] = max(worst["loss"], rel)
        gstate = {k: v.cpu() for k, v in gm.state_dict().items()}
        for k, c in cm.state_dict().items():
            g = gstate[k]
            if k.endswith(("_mean", "_variance")):
                e = (g - c).abs().max().item() / c.abs().max().item()
                check(e <= 1e-4, f"resnet-train-cpu step {step}: {k} "
                      f"differs by {e} of its max-abs")
                worst["stats"] = max(worst["stats"], e)
                continue
            vg = gopt._state[k]["velocity"].cpu()
            vc = copt._state[k]["velocity"]
            vel = (vg - vc).abs().max().item() / vc.abs().max().item()
            if k.startswith("fc."):
                perr = (g - c).abs().max().item()
                check(vel <= 1e-3 and perr <= 1e-5, f"resnet-train-cpu step "
                      f"{step}: {k} velocity {vel} of its max-abs, "
                      f"parameters {perr}")
                worst["fc_vel"] = max(worst["fc_vel"], vel)
                worst["fc_param"] = max(worst["fc_param"], perr)
                continue
            leaves += 1
            elem_ok += vel <= 1e-3
            upd = ((g - before[k]) - (c - before[k])).norm().item() / max(
                (c - before[k]).norm().item(), 1e-30)
            check(math.isfinite(upd) and upd <= 5e-2, f"resnet-train-cpu "
                  f"step {step}: {k}'s update differs by {upd} (relative "
                  "L2)")
            worst["update"] = max(worst["update"], upd)
        if step == 1:
            far = {}
            for dev, opt in (("cuda", gopt), ("cpu", copt)):
                far[dev] = sorted(
                    (opt._state[k]["velocity"].cpu().double() - g).norm()
                    .item() / g.norm().item() for k, g in g64.items())
            log("resnet-train-cpu: step 1's gradients against a float64 step "
                "of the unfused model, relative L2 (median, worst leaf): "
                + "; ".join(f"{dev} {v[len(v) // 2]:.2e}, {v[-1]:.2e}"
                            for dev, v in far.items()))
            for at in (len(g64) // 2, -1):
                check(far["cuda"][at] <= 1.5 * far["cpu"][at],
                      f"resnet-train-cpu: the card's gradients sit "
                      f"{far['cuda'][at]} from float64, the CPU twin's "
                      f"{far['cpu'][at]}")
            worst["f64"] = {dev: v[-1] for dev, v in far.items()}
        # the next step starts from the CPU's state on both devices
        gm.load_state_dict({k: v.to("cuda") for k, v in
                            cm.state_dict().items()})
        for k, st in copt._state.items():
            gopt._state[k]["velocity"].copy_(st["velocity"])
    check(kcb.fused_conv1x1_bn_act.launches == 17 * steps,
          f"resnet-train-cpu: #11 launched "
          f"{kcb.fused_conv1x1_bn_act.launches} times on the card in "
          f"{steps} steps, want {17 * steps}")
    log(f"resnet-train-cpu: resnet50 fused NHWC, f32, batch {b} x 3 x {hw} x "
        f"{hw}, Momentum(0.1, 0.9), {steps} steps (each from the CPU's "
        f"state): loss {worst['loss']:.2e} relative; running statistics "
        f"{worst['stats']:.2e} of their max-abs; fc velocity "
        f"{worst['fc_vel']:.2e} of its max-abs, fc parameters "
        f"{worst['fc_param']:.2e}; the other leaves' updates "
        f"{worst['update']:.2e} relative L2, their velocity within 1e-3 of "
        f"its max-abs in {elem_ok} of {leaves} leaf-steps")
    del gm, geng, cm, ceng
    torch.cuda.empty_cache()
    return dict(worst, elem_ok=elem_ok, leaves=leaves)


# -- paddle.Model over io.DataLoader (phases fit-resnet50, fit-lenet) ---------

def _zero_launches():
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    for w in WRAPPERS:
        w.launches = 0


def _read_launches():
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    return {w.__name__: w.launches for w in WRAPPERS}


def _only(tag, launches, name, want):
    """Exactly ``want`` launches of ``name`` and none of another kernel."""
    check(launches[name] == want, f"{tag}: {name} launched "
          f"{launches[name]} times, want {want}")
    others = {n: c for n, c in launches.items() if c and n != name}
    check(not others, f"{tag}: other kernels of the port launched {others}")


class _FitProbe:
    """A fit callback: the wall clock at every batch end (each step ends in
    the float read of its loss, so these are step boundaries) and the loss;
    one step profiled, from the end of batch ``profile_after`` to the end
    of the next."""

    def __init__(self, torch, profile_after):
        from paddle_tpu_torch.hapi.callbacks import Callback
        probe = self

        class _CB(Callback):
            def on_train_batch_begin(self, step, logs=None):
                probe.begins.append(time.perf_counter())

            def on_train_batch_end(self, step, logs=None):
                probe.batch_end(step, logs)

        self.callback = _CB()
        self.torch = torch
        self.profile_after = profile_after
        self.begins, self.ends, self.losses = [], [], []
        self.prof, self.prof_wall = None, None

    def gaps_ms(self, first, last):
        """Host time from each step's end to the next one's begin (the
        next batch's wait, its copy issued, the loop), steps first..last
        (0-based), sorted."""
        return sorted((self.begins[i + 1] - self.ends[i]) * 1e3
                      for i in range(first, last))

    def batch_end(self, step, logs):
        from torch.profiler import ProfilerActivity, profile
        step = len(self.ends)  # counted over every epoch
        if step == self.profile_after + 1 and self.prof is not None:
            self.torch.cuda.synchronize()
            self.prof_wall = time.perf_counter() - self.prof_t0
            self.prof.stop()
        self.ends.append(time.perf_counter())
        self.losses.append(logs["loss"][0])
        if step == self.profile_after:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_t0 = time.perf_counter()

    def busy(self, tag):
        """The profiled step: device busy time over its wall time."""
        from torch.autograd import DeviceType
        avgs = self.prof.key_averages()
        rows = [a for a in avgs if a.device_type == DeviceType.CUDA]
        busy = sum(a.self_device_time_total for a in rows) / 1e6
        launches = sum(a.count for a in avgs if a.key in LAUNCH_CALLS)
        copies = sum(a.self_device_time_total for a in rows
                     if "memcpy" in a.key.lower()) / 1e3
        if busy <= 0:
            log(f"{tag}: the profiler recorded no device time; busy share "
                "not measured")
            return dict(busy_share=None, launch_calls=launches)
        log(f"{tag}: one fit step profiled (batch end to batch end: the "
            f"next batch's wait and copy, the step, the loss and metric "
            f"reads): wall {self.prof_wall * 1e3:.3f} ms, device busy "
            f"{busy * 1e3:.3f} ms = {busy / self.prof_wall:.3f} of it; "
            f"memcpy {copies:.3f} ms; {launches} kernel launches by the "
            f"host, {sum(a.count for a in rows)} device kernels")
        top = sorted(rows, key=lambda a: a.self_device_time_total,
                     reverse=True)
        for a in top[:8] + [a for a in top[8:]
                            if "memcpy" in a.key.lower()]:
            log(f"{tag}:   {a.self_device_time_total / 1e3:9.3f} ms  "
                f"x{a.count:<5d} {a.key[:90]}")
        return dict(busy_share=busy / self.prof_wall, device_ms=busy * 1e3,
                    wall_ms=self.prof_wall * 1e3, memcpy_ms=copies,
                    launch_calls=launches)


def _resnet_fit_model(torch, weight_seed):
    """The fit-resnet50 Model: resnet50 NHWC with the fused bottleneck,
    Momentum(0.1, 0.9), CrossEntropyLoss, Accuracy(topk=(1, 5)), AMP O1."""
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=1000, layout="NHWC", fused_bottleneck=True,
                   device="cuda", generator=seed(weight_seed, device="cuda"))
    model = Model(net)
    model.prepare(Momentum(0.1, momentum=0.9), nn.CrossEntropyLoss(),
                  Accuracy(topk=(1, 5)), amp_configs="O1", capture=False)
    return model


def _conv_f32_forward(torch):
    """Kernel #11 in f32 against its twin at the 12 shapes of one resnet50
    forward at batch 256 x 224 px (what evaluate and predict launch),
    timed, and summed over the forward's 32 launches."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = [_conv_case(torch, m, cin, cout, res, True, "float32", gen,
                       scratch.zero_, True)
            for m, cin, cout, res, _ in SERVE_SHAPES]
    del scratch
    total = _shape_sum(rows, [n for *_, n in SERVE_SHAPES])
    for r in rows:
        log(f"fit-resnet50: #11 f32 M={r['m']} {r['cin']}->{r['cout']} "
            f"res={r['res']}: ms {r['ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}; CUDA cores {r['cuda_core_bound_ms']:.4f}) "
            f"GEMM alone {r['gemm_ms']:.4f} max_abs_err "
            f"{r['max_abs_err']:.3e}")
    log(f"fit-resnet50: #11 in f32 at the 12 forward shapes: max_abs_err "
        f"{max(r['max_abs_err'] for r in rows):.3e}; the 32 launches of one "
        f"forward {total['ms']:.4f} ms against a bound of "
        f"{total['bound_ms']:.4f} ms ({total['bound_by']}, 3xTF32; "
        f"{total['bound_ms'] / total['ms']:.3f} of it) and the CUDA cores' "
        f"{total['cuda_core_bound_ms']:.4f} ms "
        f"({total['cuda_core_bound_ms'] / total['ms']:.3f} of it); twin "
        f"{total['plain_ms']:.4f} ms; cuBLAS's f32 GEMM alone (TF32 off; "
        f"computes less than #11) {total['gemm_ms']:.4f} ms")
    return dict(rows=rows, total=total)


def phase_fit_resnet50(torch, engine_direct):
    """paddle.Model over io.DataLoader at full width: resnet50 fused NHWC,
    AMP O1, Momentum, Accuracy top-1/5; fit 13 steps at batch 256 x 224 px
    from SyntheticImageNet (2 thread workers, shuffle, drop_last; steps
    4-13 timed, step 3 profiled), then evaluate and predict over 512
    held-out images, save, load into a fresh Model and evaluate again."""
    import tempfile

    import numpy as np
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.vision.datasets import SyntheticImageNet
    tag, b, steps, held_n = "fit-resnet50", 256, 13, 512
    ds = SyntheticImageNet(n=b * steps + held_n, image_size=224)
    train = Subset(ds, range(b * steps))
    held = Subset(ds, range(b * steps, b * steps + held_n))
    t0 = time.perf_counter()
    model = _resnet_fit_model(torch, 0)
    net = model.network
    stats0 = {n: t.clone() for n, t in net.named_buffers()}
    torch.cuda.synchronize()
    log(f"{tag}: resnet50 built on cuda in {time.perf_counter() - t0:.2f} "
        f"s; Model.prepare(Momentum(0.1, 0.9), CrossEntropyLoss(), "
        f"Accuracy(topk=(1, 5)), amp_configs='O1')")
    probe = _FitProbe(torch, profile_after=1)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    model.fit(train, batch_size=b, epochs=1, shuffle=True, drop_last=True,
              num_workers=2, verbose=0, callbacks=[probe.callback])
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    launches = _read_launches()
    _only(tag, launches, "fused_conv1x1_bn_act", 17 * steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(probe.losses) == steps and all(
        math.isfinite(v) for v in probe.losses), f"{tag}: losses "
        f"{probe.losses}")
    moved = sum(not torch.equal(t, stats0[n]) for n, t in
                net.named_buffers())
    check(moved == len(stats0), f"{tag}: {len(stats0) - moved} running "
          "statistics did not move")
    window = probe.ends[steps - 1] - probe.ends[2]  # steps 4-13
    gaps = probe.gaps_ms(2, steps - 1)
    loader = model._loaders["train"]
    res = dict(launches=launches, steps=steps, losses=probe.losses,
               images_per_s=b * 10 / window, ms_per_step=window / 10 * 1e3,
               fit_wall_s=fit_wall, peak_gib=peak,
               wait_ms_per_batch=loader.batch_wait_s / loader.batches * 1e3,
               gap_ms_median=gaps[len(gaps) // 2], gap_ms_max=gaps[-1],
               engine_images_per_s=engine_direct["images_per_s"],
               engine_ms_per_step=engine_direct["ms_per_step"])
    res["profile"] = probe.busy(tag)
    # the profiler slows the host, not the device: the profiled step's
    # device time over an unprofiled step's wall is the busy share the
    # timed window ran at
    dev_ms = res["profile"].get("device_ms")
    res["device_over_step"] = None if dev_ms is None else \
        dev_ms / res["ms_per_step"]
    log(f"{tag}: the profiled step's device time over steps 4-13's ms a "
        f"step: {res['device_over_step']}")
    log(f"{tag}: fit of {steps} steps in {fit_wall:.3f} s; steps 4-13 "
        f"{res['ms_per_step']:.3f} ms/step = {res['images_per_s']:.1f} "
        f"images/s (Engine direct, phase resnet-train, this run: "
        f"{res['engine_images_per_s']:.1f}); the loader's wait "
        f"{res['wait_ms_per_batch']:.3f} ms a batch over {loader.batches} "
        f"batches; host time from a step's end to the next one's begin "
        f"(steps 4-13) median {res['gap_ms_median']:.3f} ms, max "
        f"{res['gap_ms_max']:.3f}; #11 x 17 a step, no other kernel of the "
        f"port; loss "
        f"{probe.losses[0]:.4f} -> {probe.losses[-1]:.4f}; "
        f"max_memory_allocated {peak:.2f} GiB")

    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = model.evaluate(held, batch_size=b, num_workers=2, verbose=0)
    torch.cuda.synchronize()
    eval_s = [time.perf_counter() - t0]
    _only(f"{tag} evaluate", _read_launches(), "fused_conv1x1_bn_act",
          32 * held_n // b)
    _zero_launches()
    pred = model.predict(held, batch_size=b, num_workers=2,
                         stack_outputs=True)
    _only(f"{tag} predict", _read_launches(), "fused_conv1x1_bn_act",
          32 * held_n // b)
    check(pred[0].shape == (held_n, 1000) and pred[0].dtype == np.float32
          and bool(np.isfinite(pred[0]).all()), f"{tag}: predict gave "
          f"{pred[0].shape} {pred[0].dtype}")
    check(math.isfinite(first["loss"][0]) and
          0.0 <= first["acc_top1"] <= first["acc_top5"] <= 1.0,
          f"{tag}: evaluate {first}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resnet50")
        model.save(path)
        fresh = _resnet_fit_model(torch, 1)
        fresh.load(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fresh.evaluate(held, batch_size=b, num_workers=2,
                               verbose=0)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
        sizes = {ext: os.path.getsize(path + ext)
                 for ext in (".pdparams", ".pdopt")}
    check(again == first, f"{tag}: the reloaded Model evaluates {again}, "
          f"the first {first}")
    check(fresh._engine._step == steps, f"{tag}: reloaded engine step "
          f"{fresh._engine._step}")
    log(f"{tag}: evaluate over {held_n} held-out images {first} (#11 x 32 "
        f"a forward, f32); predict {pred[0].shape}; save "
        f"({sizes['.pdparams'] / 2 ** 20:.1f} + "
        f"{sizes['.pdopt'] / 2 ** 20:.1f} MiB) and load into a fresh "
        "Model: evaluate bit for bit the first one's")
    # evaluate's images/s (the first call, and the reloaded Model's), and
    # one f32 eval forward profiled: its device time and #11's share
    res["eval_images_per_s"] = [held_n / t for t in eval_s]
    x = _resnet_input(torch, b, 224, torch.float32)
    res["eval_profile"] = profile_forward(torch, f"{tag} evaluate",
                                          fresh.network, x)
    del x
    log(f"{tag}: evaluate over {held_n} images ({held_n // b} batches of "
        f"{b}, f32, the loader's two workers): "
        f"{res['eval_images_per_s'][0]:.1f} images/s, the reloaded Model's "
        f"{res['eval_images_per_s'][1]:.1f}; one f32 forward at batch {b}: "
        f"device {res['eval_profile'].get('device_ms')} ms, #11 "
        f"{res['eval_profile'].get('conv_share')} of it")
    # one batch's copy to the card from pinned memory, as device_prefetch
    # issues it (the images; the labels are 2 KB), held and timed alone
    x = torch.empty((b, 3, 224, 224), pin_memory=True)
    res["h2d_ms"] = time_ms(torch, lambda: x.to("cuda", non_blocking=True))
    log(f"{tag}: one batch's images pinned -> cuda ({x.nbytes / 1e6:.1f} "
        f"MB): {res['h2d_ms']:.3f} ms = "
        f"{x.nbytes / res['h2d_ms'] / 1e6:.1f} GB/s")
    del x
    res.update(evaluate=first, conv_f32=_conv_f32_forward(torch),
               eval_launches=2 * 32 * held_n // b)
    del model, fresh, net
    torch.cuda.empty_cache()
    return res


class _ModelSteps:
    """Model.train_batch in the shape _cross_device_step drives an
    Engine: (loss tensor, outputs), and the optimizer."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.optimizer = model._optimizer

    def train_batch(self, inputs, labels):
        loss = self.model.train_batch(inputs, labels)[0][0]
        return self.torch.tensor(loss), None


def phase_fit_lenet(torch):
    """The reference's smoke test through Model on the card: LeNet,
    MNIST(mode="train") (6000 synthetic images), Adam(1e-3,
    fused_kernel=True), 6 epochs at batch 256 (24 steps an epoch, one
    launch of #10 a step over all 10 leaves), evaluate(MNIST(mode="test"))
    over 0.95; #10 over that leaf set against its twin, timed; then 3
    train_batch calls
    on the card and on the CPU from the same weights, phase 8's bars."""
    import numpy as np
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    tag = "fit-lenet"

    def build(device, weight_seed=0):
        net = LeNet(device=device, generator=seed(weight_seed,
                                                  device=device))
        m = Model(net)
        m.prepare(Adam(1e-3, parameters=net.parameters(), fused_kernel=True),
                  nn.CrossEntropyLoss(), Accuracy(), capture=False)
        return m

    model = build("cuda")
    train = MNIST(mode="train")
    np.random.seed(0)  # the shuffle order
    _zero_launches()
    t0 = time.perf_counter()
    with _AdamWWatch() as watch:
        model.fit(train, epochs=6, batch_size=256, verbose=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _only(tag, launches, "fused_adamw_multi_update", 6 * 24)
    leaves = _check_adamw_route(tag, model.network, model._optimizer, watch,
                                launches, 6 * 24)
    res = model.evaluate(MNIST(mode="test"), batch_size=256, verbose=0)
    check(res["acc"] > 0.95, f"{tag}: evaluate {res}")
    loader = model._loaders["train"]
    log(f"{tag}: fit 6 epochs x 24 steps in {wall:.3f} s "
        f"({wall / 6:.3f} s an epoch, {6 * len(train) / wall:.1f} images/s; "
        f"the loader's wait "
        f"{loader.batch_wait_s / loader.batches * 1e3:.3f} ms a batch); "
        f"#10 x {launches['fused_adamw_multi_update']} (one a step over "
        f"all {leaves} leaves), no other kernel; evaluate {res}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    adamw = _adamw_set_case(
        torch, "lenet", [(n, tuple(p.shape)) for n, p in
                         model.network.named_parameters()],
        gen, scratch.zero_, decoupled=False, wd=0.0)
    del scratch

    gm, cm = build("cuda", 1), build("cpu", 2)
    cm.network.load_state_dict({k: v.cpu() for k, v in
                                gm.network.state_dict().items()})
    rng = np.random.default_rng(28)
    idx = rng.permutation(len(train))[:256]
    x = np.stack([train[i][0] for i in idx])
    y = np.stack([train[i][1] for i in idx])
    batches = {"cuda": ([torch.from_numpy(x).cuda()],
                        [torch.from_numpy(y).cuda()]),
               "cpu": ([torch.from_numpy(x)], [torch.from_numpy(y)])}
    worst = {}
    for step in range(1, 4):
        r = _cross_device_step(
            f"{tag} cpu step {step}", "LeNet, batch 256, f32, Adam fused",
            {"cuda": gm.network, "cpu": cm.network},
            {"cuda": _ModelSteps(torch, gm), "cpu": _ModelSteps(torch, cm)},
            batches, nn.CrossEntropyLoss())
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in r.items()}
        # the next step starts from the CPU's state on both devices
        gm.network.load_state_dict({k: v.cuda() for k, v in
                                    cm.network.state_dict().items()})
        for n, st in cm._optimizer._state.items():
            for k, t in st.items():
                gm._optimizer._state[n][k].copy_(t)
    return dict(launches=launches, wall_s=wall, evaluate=res, adamw=adamw,
                adamw_leaves=leaves, cpu=worst)


# -- detection serving: DETR-R50 and PP-YOLOE-l --------------------------------

# DETR's eval resize (shorter side 800, longer at most 1333): a 25 x 42
# feature map at stride 32, 1050 encoder tokens
DETR_HW = (800, 1333)
# PP-YOLOE-l as PaddleDetection's ppyoloe_crn_l sizes it (depth_mult and
# width_mult 1.0) at its 640 x 640 eval size: 80 x 80 + 40 x 40 + 20 x 20
# = 8400 anchors
PPYOLOE_L = dict(num_classes=80, layers=(3, 6, 6, 3),
                 channels=(64, 128, 256, 512, 1024))
# device kernels of a detection forward, grouped by name (first match wins)
DETECT_GROUPS = (
    ("#1 (flash_fwd_f32_kernel)", ("flash_fwd",)),
    ("cuDNN convolutions (FFT and layout transposes included)",
     ("fprop", "dgrad", "wgrad", "implicit", "conv", "winograd", "cudnn",
      "nhwc", "nchw", "fft", "dse::", "pointwise_mult_and_sum")),
    ("GEMMs (projections, feed-forward, heads)",
     ("gemm", "cutlass", "cublas")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("elementwise and reductions (eager BatchNorm, activations, residuals, "
     "copies, softmax, pools)",
     ("elementwise", "reduce", "copy", "fill", "cat", "index", "softmax",
      "pool")),
)


def _images(torch, b, h, w, seed=0, device="cuda"):
    import numpy as np
    x = np.random.default_rng(seed).standard_normal((b, 3, h, w))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _serve(torch, tag, model, x, want, steps=10):
    """``model`` in eval under inference_mode on the card: 2 warm-up
    forwards, one counted forward (``want``: {kernel: launches}, every
    other kernel of the port at 0), then ``steps`` forwards ending in one
    sync, which must launch ``want`` x ``steps``. Returns (the counted
    forward's outputs, launches, images/s, ms a forward)."""
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        _zero_launches()
        out = model(x)
        torch.cuda.synchronize()
        launches = _read_launches()
        for name, n in launches.items():
            check(n == want.get(name, 0), f"{tag}: {name} launched {n} "
                  f"times in one forward, want {want.get(name, 0)}")
        _zero_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            model(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, n in _read_launches().items():
            check(n == want.get(name, 0) * steps,
                  f"{tag}: {name} launched {n} times over {steps} forwards")
    return out, launches, x.shape[0] * steps / wall, wall / steps * 1e3


def _close_rel(tag, got, want, tol):
    """got within tol x max|want| of want, elementwise; returns the error
    over max|want|."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= tol * max(scale, 1e-30),
          f"{tag}: max_abs_err {err} > {tol} x max-abs {scale}")
    return err / max(scale, 1e-30)


def _inference_profile(torch, tag, model, x, groups=DETECT_GROUPS):
    def run():
        with torch.inference_mode():
            model(x)
    return profile_grouped(torch, tag, "one forward", run, groups)


def phase_detr_serve(torch):
    """DETR() at the JAX package's defaults (80 classes, 100 queries,
    d_model 256, 8 heads, 6 + 6 layers, feed-forward 2048, ResNet-50,
    NHWC on the card), weights from seed 0, eval, f32: batch 8 x 3 x 800
    x 1333 from numpy seed 0 under inference_mode; 18 launches of #1 a
    forward (6 encoder, 12 decoder) and no other kernel of the port;
    images/s over 10 forwards ending in one sync, peak memory, one forward
    profiled. Returns the model for phase detr-cpu."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision.models import DETR
    tag, b, (h, w) = "detr-serve", 8, DETR_HW
    torch.cuda.reset_peak_memory_stats()
    model = DETR(device="cuda", generator=seed(0)).eval()
    attn = model.transformer.encoder.layers[0].self_attn
    check(attn.head_dim == 32 and model.num_queries == 100
          and len(model.transformer.decoder.layers) == 6
          and model.backbone._layout == "NHWC",
          f"{tag}: not DETR-R50's configuration")
    x = _images(torch, b, h, w)
    (boxes, probs), launches, ips, ms = _serve(
        torch, tag, model, x, {"flash_attention_fwd": 18})
    check(tuple(boxes.shape) == (b, 100, 4)
          and tuple(probs.shape) == (b, 100, 81)
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(probs).all()),
          f"{tag}: boxes {tuple(boxes.shape)} / probs {tuple(probs.shape)}"
          " not finite [8, 100, 4] / [8, 100, 81]")
    check(float((probs.sum(-1) - 1).abs().max()) <= 1e-4,
          f"{tag}: class probabilities do not sum to 1")
    check(float(boxes[..., 0::2].min()) >= -w / 2
          and float(boxes[..., 0::2].max()) <= 1.5 * w,
          f"{tag}: boxes outside the image's frame")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag}: DETR-R50 f32, batch {b} x {h} x {w}: {ips:.2f} images/s, "
        f"{ms:.3f} ms a forward (10 forwards, one sync), #1 x 18 a forward "
        f"(B*H 64, D 32: 6 x 1050 x 1050, 6 x 100 x 100, 6 x 100 x 1050), "
        f"peak {peak:.2f} GiB")
    prof = _inference_profile(torch, tag, model, x)
    return dict(model=model, launches=launches, images_per_s=ips,
                ms_per_forward=ms, peak_gib=peak, profile=prof)


def phase_detr_cpu(torch, gm):
    """The detr-serve model (BatchNorm statistics drawn at random) and a
    CPU copy of it, NHWC both, on one 800 x 1333 image: boxes and class
    probabilities within 1e-3 of their max-abs, the top class of every
    query equal."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    from paddle_tpu_torch.vision.models import DETR
    tag = "detr-cpu"
    _randomize_bn(torch, gm, 22)
    cm = DETR(layout="NHWC", device="cpu",
              generator=seed(1, device="cpu")).eval()
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    x = _images(torch, 1, *DETR_HW, seed=6)
    with torch.inference_mode():
        kfa.flash_attention_fwd.launches = 0
        bg, pg = gm(x)
        check(kfa.flash_attention_fwd.launches == 18,
              f"{tag}: the card launched #1 "
              f"{kfa.flash_attention_fwd.launches} times, want 18")
        bc, pc = cm(x.cpu())
        check(kfa.flash_attention_fwd.launches == 18,
              f"{tag}: the CPU side counted a launch")
    eb = _close_rel(f"{tag} boxes", bg, bc, 1e-3)
    perr, _ = _logits_close(f"{tag} probs", pg[0], pc[0])
    log(f"{tag}: DETR-R50 f32, 1 x {DETR_HW[0]} x {DETR_HW[1]}, cuda vs "
        f"cpu: boxes {eb:.3e} of their max-abs, probabilities max_abs_err "
        f"{perr:.3e}; the top class of all 100 queries equal")
    return dict(boxes=eb, probs=perr)


def phase_ppyoloe_serve(torch):
    """PP-YOLOE-l (CSPResNet layers (3, 6, 6, 3), channels (64, 128, 256,
    512, 1024), 80 classes), weights from seed 0 with random BatchNorm
    statistics, eval, f32: batch 8 x 3 x 640 x 640 from numpy seed 0, no
    kernel of the port (its convolutions are cuDNN's); images/s over 10
    forwards ending in one sync, peak memory, one forward profiled; then
    folded by incubate.fuse_conv_bn: its outputs within 1e-4 of the
    unfolded ones' max-abs, its images/s; then multiclass_nms on one
    image's output, timed on the host. Returns the unfolded state for
    phase ppyoloe-cpu."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate import fuse_conv_bn
    from paddle_tpu_torch.vision.models import PPYOLOE, multiclass_nms
    tag, b, hw = "ppyoloe-serve", 8, 640
    torch.cuda.reset_peak_memory_stats()
    model = PPYOLOE(**PPYOLOE_L, device="cuda", generator=seed(0)).eval()
    _randomize_bn(torch, model, 23)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    x = _images(torch, b, hw, hw)
    (boxes, scores), _, ips, ms = _serve(torch, tag, model, x, {})
    a = sum((hw // s) ** 2 for s in (8, 16, 32))
    check(tuple(boxes.shape) == (b, a, 4)
          and tuple(scores.shape) == (b, a, 80)
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(scores).all()),
          f"{tag}: boxes {tuple(boxes.shape)} / scores "
          f"{tuple(scores.shape)} not finite [{b}, {a}, 4] / [{b}, {a}, "
          "80]")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag}: PP-YOLOE-l f32, batch {b} x {hw} x {hw}: {ips:.2f} "
        f"images/s, {ms:.3f} ms a forward (10 forwards, one sync), no "
        f"kernel of the port, peak {peak:.2f} GiB")
    prof = _inference_profile(torch, tag, model, x)

    model, folded = fuse_conv_bn(model)
    (fb, fs), _, fips, fms = _serve(torch, f"{tag} folded", model, x, {})
    eb = _close_rel(f"{tag} folded boxes", fb, boxes, 1e-4)
    es = _close_rel(f"{tag} folded scores", fs, scores, 1e-4)
    log(f"{tag}: fuse_conv_bn folded {folded} pairs: {fips:.2f} images/s, "
        f"{fms:.3f} ms a forward ({fips / ips:.3f} of the unfolded); "
        f"outputs from the unfolded ones: boxes {eb:.3e}, scores {es:.3e} "
        "of their max-abs")

    b0, s0 = boxes[0].cpu().numpy(), scores[0].cpu().numpy()
    t0 = time.perf_counter()
    dets = multiclass_nms(b0, s0)
    nms_s = time.perf_counter() - t0
    check(len(dets) == 100 and all(0 <= c < 80 for c, _, _ in dets),
          f"{tag}: multiclass_nms gave {len(dets)} detections")
    log(f"{tag}: multiclass_nms (score 0.05, iou 0.6, 100 kept) on one "
        f"image's {a} anchors x 80 classes, {(s0 > 0.05).sum()} scores "
        f"above 0.05 (range {s0.min():.3f}..{s0.max():.3f}): "
        f"{nms_s * 1e3:.1f} ms on the host")
    return dict(state=state, images_per_s=ips, ms_per_forward=ms,
                peak_gib=peak, profile=prof, folded=folded,
                folded_images_per_s=fips, folded_err=max(eb, es),
                nms_ms=nms_s * 1e3)


def _top1_clear(tag, got, want):
    """The top class of every row of ``got`` (the card's scores) equal to
    ``want``'s (the CPU's) wherever the CPU's top two lie further apart
    than twice the devices' largest difference -> (rows clear of a tie,
    rows whose top class differs, that difference)."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[clear].all()), f"{tag}: the top class differs at "
          f"{int((~same & clear).sum())} rows whose top two lie further "
          "apart than twice the devices' difference")
    return int(clear.sum()), int((~same).sum()), err


def phase_ppyoloe_cpu(torch, state):
    """PP-YOLOE-l with the ppyoloe-serve weights on the card and on the
    CPU, one 640 x 640 image: boxes and scores within 1e-3 of their
    max-abs; the top class of every anchor equal wherever the CPU's top
    two scores lie further apart than twice the largest score difference
    between the devices. With random weights every score sits near 0.5:
    over 8400 anchors x 80 classes the closest top two differ by ~1e-6
    (a CPU run of this phase), about the two devices' difference, so an
    anchor inside that band may take either class on either device."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision.models import PPYOLOE
    tag = "ppyoloe-cpu"
    gm = PPYOLOE(**PPYOLOE_L, device="cuda", generator=seed(2)).eval()
    cm = PPYOLOE(**PPYOLOE_L, device="cpu",
                 generator=seed(3, device="cpu")).eval()
    gm.load_state_dict(state)
    cm.load_state_dict(state)
    x = _images(torch, 1, 640, 640, seed=7)
    with torch.inference_mode():
        bg, sg = gm(x)
        bc, sc = cm(x.cpu())
    eb = _close_rel(f"{tag} boxes", bg, bc, 1e-3)
    es = _close_rel(f"{tag} scores", sg, sc, 1e-3)
    clear, differ, serr = _top1_clear(tag, sg[0], sc[0])
    n = sc.shape[1]
    log(f"{tag}: PP-YOLOE-l f32, 1 x 640 x 640, cuda vs cpu: boxes "
        f"{eb:.3e}, scores {es:.3e} of their max-abs (max_abs_err "
        f"{serr:.3e}); the top class equal at {clear} of {n} anchors clear "
        f"of a tie, {n - clear} within 2 x {serr:.1e} of one ({differ} "
        "differ)")
    return dict(boxes=eb, scores=es)


# -- detection training: DETR-R50 and PP-YOLOE-l through Model.fit ------------

# device kernels of a detection training step, grouped by name (first match
# wins)
DETECT_TRAIN_GROUPS = (
    ("#1 (flash_fwd_f32_kernel)", ("flash_fwd",)),
    ("#3 (flash_bwd_dq_f32_kernel)", ("flash_bwd_dq",)),
    ("#4 (flash_bwd_dkv_f32_kernel)", ("flash_bwd_dkv",)),
    ("#10 (adamw_kernel)", ("adamw_kernel",)),
    ("cuDNN convolutions, forward and backward (FFT and layout transposes "
     "included)",
     ("fprop", "dgrad", "wgrad", "implicit", "conv", "winograd", "cudnn",
      "nhwc", "nchw", "fft", "dse::", "pointwise_mult_and_sum")),
    ("GEMMs (projections, feed-forward, heads)",
     ("gemm", "cutlass", "cublas")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("foreach (Momentum, the small AdamW leaves, the clip)",
     ("multi_tensor_apply",)),
    ("elementwise and reductions (eager BatchNorm, activations, residuals, "
     "copies, softmax, pools, the losses and the matcher)",
     ("elementwise", "reduce", "copy", "fill", "cat", "index", "softmax",
      "pool", "gather", "scatter", "sort", "topk", "arg")),
)
# gt slots an image (padded) and the images of a training set that fit
# repeats epoch after epoch, so the loss must fall on the images it saw
DETECT_GT_SLOTS = 20


class _DetectionSet:
    """Four-field samples from a numpy seed: an image [3, h, w] f32 (normal
    draws), gt boxes [20, 4], classes [20] (80 classes) and the slots'
    mask [20], with 1-20 real boxes an image. DETR's boxes are cxcywh
    normalised, w and h in [0.05, 0.5]; PP-YOLOE's (``pixels=True``) the
    same boxes as xyxy pixels."""

    def __init__(self, n, h, w, seed, pixels=False):
        import numpy as np
        rng = np.random.default_rng(seed)
        m = DETECT_GT_SLOTS
        self.x = rng.standard_normal((n, 3, h, w), dtype=np.float32)
        wh = rng.uniform(0.05, 0.5, (n, m, 2))
        ctr = rng.uniform(wh / 2, 1 - wh / 2)
        box = np.concatenate([ctr, wh], -1)
        if pixels:
            scale = np.array([w, h, w, h])
            box = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1) * scale
        self.gb = box.astype(np.float32)
        self.gc = rng.integers(0, 80, (n, m)).astype(np.int64)
        real = rng.integers(1, m + 1, (n, 1))
        self.gm = (np.arange(m)[None] < real).astype(np.float32)
        self.gb[self.gm == 0] = 0
        self.gc[self.gm == 0] = 0

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.gb[i], self.gc[i], self.gm[i]

    def batch(self, torch, idx, device):
        return [torch.from_numpy(a[idx]).to(device)
                for a in (self.x, self.gb, self.gc, self.gm)]


def _detection_set(n, h, w, seed, pixels=False):
    """A _DetectionSet that is an io.Dataset (Model.fit wraps a Dataset in
    its DataLoader)."""
    from paddle_tpu_torch.io import Dataset
    return type("DetectionSet", (_DetectionSet, Dataset), {})(
        n, h, w, seed, pixels)


def _detr_adamw(model, fused=True):
    """PaddleDetection's DETR recipe: AdamW(1e-4, weight_decay=1e-4) with
    the global-norm clip at 0.1."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(1e-4, parameters=model.named_parameters(),
                 weight_decay=1e-4, grad_clip=ClipGradByGlobalNorm(0.1),
                 fused_kernel=fused)


def _ppyoloe_momentum(model):
    """PaddleDetection's PP-YOLOE recipe (ppyoloe_crn_l): Momentum(0.9)
    with L2 weight decay 5e-4, its base lr 0.025 for 8 cards x 20 images
    scaled linearly to one batch of 8: 0.00125 (its linear warmup from 0
    left out: over a smoke run's 16 steps it would hold the lr near 0). At
    lr 0.01 the loss of the reference's initialisation (no prior on the
    classification bias) first climbs 24-fold (a CPU run at 320 px)."""
    from paddle_tpu_torch.optimizer import Momentum
    return Momentum(0.00125, momentum=0.9,
                    parameters=model.named_parameters(), weight_decay=5e-4)


def _fit_detection(torch, tag, model, ds, b, epochs, profile_after):
    """Model.fit over ``ds`` (io.DataLoader, 2 thread workers, no
    shuffle), launch counts zeroed before and read after, with a probe
    stamping every step and profiling step ``profile_after + 1`` (ahead of
    the timed steps: starting the profiler costs the host seconds):
    (launches, probe, wall s, peak GiB)."""
    probe = _FitProbe(torch, profile_after=profile_after)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    model.fit(ds, batch_size=b, epochs=epochs, shuffle=False,
              num_workers=2, verbose=0, callbacks=[probe.callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = epochs * (len(ds) // b)
    check(len(probe.losses) == steps and all(
        math.isfinite(v) for v in probe.losses),
        f"{tag}: losses {probe.losses}")
    # the same images open the first epoch and the last
    per_epoch = len(ds) // b
    first = probe.losses[:per_epoch]
    last = probe.losses[-per_epoch:]
    check(sum(last) < sum(first), f"{tag}: the loss did not fall: first "
          f"epoch {first}, last {last}")
    return launches, probe, wall, peak


def _step_rates(tag, model, probe, b, warm):
    """ms a step and images/s over the steps after ``warm`` (each ends in
    the loss's read, so their ends are step boundaries), the epochs'
    starts included; the median step, the loader's wait a batch and the
    host's median time from a step's end to the next one's begin."""
    n = len(probe.ends) - warm
    window = probe.ends[-1] - probe.ends[warm - 1]
    steps = sorted((probe.ends[i] - probe.ends[i - 1]) * 1e3
                   for i in range(warm, len(probe.ends)))
    gaps = probe.gaps_ms(warm - 1, len(probe.ends) - 1)
    loader = model._loaders["train"]
    r = dict(ms_per_step=window / n * 1e3, images_per_s=b * n / window,
             median_step_ms=steps[len(steps) // 2],
             wait_ms_per_batch=loader.batch_wait_s / loader.batches * 1e3,
             gap_ms_median=gaps[len(gaps) // 2], gap_ms_max=gaps[-1])
    log(f"{tag}: steps {warm + 1}-{len(probe.ends)}: "
        f"{r['ms_per_step']:.3f} ms a step ({r['images_per_s']:.2f} "
        f"images/s), the median step {r['median_step_ms']:.3f} ms; the "
        f"loader's wait {r['wait_ms_per_batch']:.3f} ms a batch over "
        f"{loader.batches} batches; host time from a step's end to the "
        f"next one's begin median {r['gap_ms_median']:.3f} ms, max "
        f"{r['gap_ms_max']:.3f}")
    return r


def phase_detr_train(torch):
    """DETR() at the JAX package's defaults (ResNet-50 NHWC, d_model 256, 8
    heads, 6 + 6 layers, feed-forward 2048, 100 queries, dropout 0.1, f32),
    weights from seed 0, through Model(net, inputs=[one]).prepare(AdamW(
    1e-4, weight_decay=1e-4, fused_kernel=True, ClipGradByGlobalNorm(0.1)),
    DETRLoss(80)).fit over io.DataLoader (2 workers): 16 images of 800 x
    1333 with 1-20 gts each, batch 4, 4 epochs (16 steps; steps 5-16
    timed, each epoch's start included): 18 launches of each of #1, #3,
    #4 a step and one of #10 over every leaf, no other kernel of the
    port; the loss falls; the auction's host reads and iterations a step;
    peak memory; one Model.train_batch profiled; the auction timed alone
    on one batch's cost."""
    from paddle_tpu_torch import Model, seed
    from paddle_tpu_torch.vision.models import DETR, DETRLoss
    from paddle_tpu_torch.vision.models.detection import detr as port_detr
    tag, b, epochs, warm = "detr-train", 4, 4, 4
    ds = _detection_set(4 * b, *DETR_HW, seed=40)
    net = DETR(device="cuda", generator=seed(0))
    attn = net.transformer.encoder.layers[0].self_attn
    check(attn.head_dim == 32 and attn.dropout == 0.1
          and net.num_queries == 100
          and len(net.transformer.decoder.layers) == 6
          and net.backbone._layout == "NHWC",
          f"{tag}: not DETR-R50's configuration")
    model = Model(net, inputs=["images"])  # one input, three labels
    model.prepare(_detr_adamw(net), DETRLoss(num_classes=80))
    # the loss reads the device from the host: the Engine runs DETR's
    # steps eagerly, and says why
    check(not model._engine.captures and "auction_match" in str(
        model._engine.eager_reason), f"{tag}: the Engine captures DETR's "
        f"step ({model._engine.eager_reason})")
    log(f"{tag}: the Engine runs DETR's steps eagerly: "
        f"{model._engine.eager_reason}")
    syncs0 = port_detr.auction_match.host_syncs
    iters0 = port_detr.auction_match.iterations
    # the backward's calls by (sq, sk): each launches #3 and #4 once
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    bwd_shapes, bwd = {}, kfa.flash_attention_bwd

    def counted_bwd(q, k, *args):
        key = (q.shape[1], k.shape[1])
        bwd_shapes[key] = bwd_shapes.get(key, 0) + 1
        return bwd(q, k, *args)
    kfa.flash_attention_bwd = counted_bwd
    try:
        with _AdamWWatch() as watch:
            launches, probe, wall, peak = _fit_detection(
                torch, tag, model, ds, b, epochs, profile_after=warm - 2)
    finally:
        kfa.flash_attention_bwd = bwd
    steps = len(probe.losses)
    want_shapes = {(sq, sk): 6 * steps for _, sq, sk in DETR_ATTENTION}
    check(bwd_shapes == want_shapes, f"{tag}: the flash backward ran at "
          f"{bwd_shapes} over {steps} steps, want {want_shapes}")
    leaves = _check_adamw_route(tag, net, model._optimizer, watch, launches,
                                steps)
    want = {"flash_attention_fwd": 18 * steps,
            "flash_attention_bwd_dq": 18 * steps,
            "flash_attention_bwd_dkv": 18 * steps,
            "fused_adamw_multi_update": launches["fused_adamw_multi_update"]}
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{tag}: {name} launched {n} times "
              f"over {steps} steps, want {want.get(name, 0)}")
    syncs = port_detr.auction_match.host_syncs - syncs0
    iters = port_detr.auction_match.iterations - iters0
    res = dict(launches=launches, bwd_shapes=bwd_shapes, steps=steps,
               losses=probe.losses, peak_gib=peak, fit_wall_s=wall,
               adamw_leaves=leaves,
               auction_syncs_per_step=syncs / steps,
               auction_iters_per_step=iters / steps,
               fit_profile=probe.busy(tag))
    res.update(_step_rates(tag, model, probe, b, warm))
    log(f"{tag}: DETR-R50 f32, batch {b} x {DETR_HW[0]} x {DETR_HW[1]}, "
        f"AdamW fused + clip 0.1, Model.fit over {steps} steps ({epochs} "
        f"epochs of {len(ds)} images) in {wall:.2f} s; steps {warm + 1}-"
        f"{steps}: {res['ms_per_step']:.3f} ms a step, "
        f"{res['images_per_s']:.2f} images/s; a step launches "
        f"#1, #3 and #4 x 18 each and #10 once over all {leaves} leaves "
        f"(the clip's coefficient scaling each gradient), no other kernel "
        f"of the port; the auction "
        f"{syncs / steps:.2f} host reads and {iters / steps:.1f} iterations "
        f"a step (B x Q x M = {b} x 100 x {DETECT_GT_SLOTS}); loss "
        f"{probe.losses[0]:.4f} -> {probe.losses[-1]:.4f} (every step "
        f"{[round(v, 4) for v in probe.losses]}); max_memory_allocated "
        f"{peak:.2f} GiB")
    x, gb, gc, gm = ds.batch(torch, slice(0, b), "cuda")
    res["profile"] = profile_grouped(
        torch, tag, "one Model.train_batch", lambda: model.train_batch(
            [x], [gb, gc, gm]), DETECT_TRAIN_GROUPS)
    # the matcher alone on one batch's cost (its iterations read the stop
    # condition back, so a host clock around it, ending in a sync)
    crit = model._loss
    with torch.no_grad():
        logits, boxes = net(x)
        cost = crit.cost(logits, boxes, gb, gc.long())
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        s0, i0 = port_detr.auction_match.host_syncs, \
            port_detr.auction_match.iterations
        t0 = time.perf_counter()
        port_detr.auction_match(cost, gm > 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    res["auction_ms"] = min(walls)
    res["auction_one"] = dict(
        syncs=port_detr.auction_match.host_syncs - s0,
        iterations=port_detr.auction_match.iterations - i0)
    log(f"{tag}: the auction alone on one batch's cost [{b}, 100, "
        f"{DETECT_GT_SLOTS}]: {res['auction_ms']:.3f} ms of host time "
        f"(best of 3, each ending in a sync), "
        f"{res['auction_one']['iterations']} iterations, "
        f"{res['auction_one']['syncs']} host reads")
    del model, net, x, cost
    torch.cuda.empty_cache()
    return res


def _small_detr(torch, device, weight_seed):
    """A DETR that keeps DETR's head_dim 32 (d_model 256, 8 heads) cut to
    2 + 2 layers on the tiny backbone (4 stride-2 convolutions with
    BatchNorm), dropout 0, train mode. Not resnet18: there an f32 step on
    the CPU lies 2e-2 of a leaf's max-abs from a float64 one (a CPU run:
    a ReLU input within the f32 forward's error of 0 takes the other side
    on the other device, as resnet-train-cpu finds), against 1.4e-5 here."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision.models import DETR
    return DETR(num_encoder_layers=2, num_decoder_layers=2, backbone="tiny",
                dropout=0.0, device=device,
                generator=seed(weight_seed, device=device)).train()


def phase_detr_train_cpu(torch):
    """One training step of a small DETR (head_dim 32: d_model 256, 8 heads,
    2 + 2 layers, the tiny backbone, dropout 0) at 1 x 3 x 256 x 256 with
    1-20 gts, on the card and on the CPU from the same weights (BatchNorm
    statistics drawn at random), AdamW fused with the clip: phase 8's bars
    (_cross_device_step); the auction's matches on each device's own cost
    equal, a difference logged with the cost's margin; the card launching
    #1, #3 and #4 x 12 for the gradients and the step (6 each a forward
    and backward)."""
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.vision.models import DETRLoss
    from paddle_tpu_torch.vision.models.detection import auction_match
    tag = "detr-train-cpu"
    gm_, cm = _small_detr(torch, "cuda", 3), _small_detr(torch, "cpu", 4)
    _randomize_bn(torch, gm_, 24)
    cm.load_state_dict({k: v.cpu() for k, v in gm_.state_dict().items()})
    ds = _detection_set(1, 256, 256, seed=41)
    crit = DETRLoss(num_classes=80)
    batches = {}
    for dev in ("cuda", "cpu"):
        x, gb, gc, gm = ds.batch(torch, slice(0, 1), dev)
        batches[dev] = ([x], [gb, gc, gm])
    # the matches: the auction on each device's own outputs
    match, cost = {}, {}
    with torch.no_grad():
        for dev, m in (("cuda", gm_), ("cpu", cm)):
            (x,), (gb, gc, gmask) = batches[dev]
            logits, boxes = m(x)
            cost[dev] = crit.cost(logits, boxes, gb, gc).cpu()
            match[dev] = auction_match(cost[dev].to(dev), gmask > 0).cpu()
    valid = torch.from_numpy(ds.gm[0] > 0)
    same = match["cuda"][0][valid] == match["cpu"][0][valid]
    cerr = (cost["cuda"] - cost["cpu"]).abs().max().item()
    if not bool(same.all()):
        log(f"{tag}: the matches differ at {int((~same).sum())} of "
            f"{int(valid.sum())} gts (the costs {cerr:.3e} apart)")
    check(bool(same.all()), f"{tag}: the card's matches "
          f"{match['cuda'][0][valid].tolist()} are not the CPU's "
          f"{match['cpu'][0][valid].tolist()}")
    engines = {"cuda": Engine(gm_, crit, _detr_adamw(gm_)),
               "cpu": Engine(cm, crit, _detr_adamw(cm))}
    _zero_launches()
    # the tiny backbone's convolution biases feed BatchNorms
    r = _cross_device_step(tag, "DETR head_dim 32, 2 + 2 layers, tiny "
                           "backbone, 1 x 256 x 256, f32, AdamW fused + clip",
                           {"cuda": gm_, "cpu": cm}, engines, batches, crit,
                           zero_grads=("k_proj.bias", "backbone.0.bias",
                                       "backbone.3.bias", "backbone.6.bias",
                                       "backbone.9.bias"))
    launches = _read_launches()
    n = {k: launches[k] for k in ("flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")}
    # 6 attentions a forward: the gradients' forward and the step's
    check(all(v == 12 for v in n.values()), f"{tag}: the card launched "
          f"{n}, want 12 of each (two forwards and backwards)")
    log(f"{tag}: the matches of all {int(valid.sum())} gts equal on both "
        f"devices (costs {cerr:.3e} apart); #1, #3, #4 x 12 on the card")
    r.update(matches_equal=True, cost_err=cerr)
    return r


def phase_ppyoloe_train(torch):
    """PP-YOLOE-l (PPYOLOE_L), weights from seed 0, f32, through
    Model(net, inputs=[one]).prepare(Momentum(0.00125, 0.9, L2 5e-4),
    PPYOLOECriterion(net)).fit over io.DataLoader (2 workers): 32 images of
    640 x 640 with 1-20 gts each (xyxy pixels), batch 8, 4 epochs (16
    steps; steps 5-16 timed, each epoch's start included): no kernel of
    the port (cuDNN's convolutions, Momentum's foreach kernels); the loss
    falls; peak memory; one Model.train_batch profiled."""
    from paddle_tpu_torch import Model, seed
    from paddle_tpu_torch.vision.models import PPYOLOE, PPYOLOECriterion
    tag, b, epochs, warm, hw = "ppyoloe-train", 8, 4, 4, 640
    ds = _detection_set(4 * b, hw, hw, seed=42, pixels=True)
    net = PPYOLOE(**PPYOLOE_L, device="cuda", generator=seed(0))
    model = Model(net, inputs=["images"])  # one input, three labels
    model.prepare(_ppyoloe_momentum(net), PPYOLOECriterion(net))
    launches, probe, wall, peak = _fit_detection(
        torch, tag, model, ds, b, epochs, profile_after=warm - 2)
    others = {k: v for k, v in launches.items() if v}
    check(not others, f"{tag}: kernels of the port launched: {others}")
    steps = len(probe.losses)
    res = dict(launches=launches, steps=steps, losses=probe.losses,
               peak_gib=peak, fit_wall_s=wall, fit_profile=probe.busy(tag))
    res.update(_step_rates(tag, model, probe, b, warm))
    log(f"{tag}: PP-YOLOE-l f32, batch {b} x {hw} x {hw}, Momentum("
        f"0.00125, 0.9, L2 5e-4), Model.fit over {steps} steps ({epochs} "
        f"epochs of {len(ds)} images) in {wall:.2f} s; steps {warm + 1}-"
        f"{steps}: {res['ms_per_step']:.3f} ms a step, "
        f"{res['images_per_s']:.2f} images/s;"
        f" no kernel of the port (cuDNN's convolutions, Momentum's foreach"
        f" kernels); loss {probe.losses[0]:.4f} -> {probe.losses[-1]:.4f} "
        f"(every step {[round(v, 4) for v in probe.losses]}); "
        f"max_memory_allocated {peak:.2f} GiB")
    x, gb, gc, gm = ds.batch(torch, slice(0, b), "cuda")
    res["profile"] = profile_grouped(
        torch, tag, "one Model.train_batch", lambda: model.train_batch(
            [x], [gb, gc, gm]), DETECT_TRAIN_GROUPS)
    del model, net, x
    torch.cuda.empty_cache()
    return res


def _small_ppyoloe(torch, device, weight_seed):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision.models import PPYOLOE
    return PPYOLOE(num_classes=80, channels=(16, 32, 64, 128, 256),
                   device=device,
                   generator=seed(weight_seed, device=device)).train()


def phase_ppyoloe_train_cpu(torch):
    """One training step of a small PP-YOLOE (80 classes, layers (1, 1, 1,
    1), channels (16, 32, 64, 128, 256)) at 2 x 3 x 160 x 160 with 1-20
    gts an image, on the card and on the CPU from the same weights
    (BatchNorm statistics drawn at random), Momentum(0.00125, 0.9, L2
    5e-4): phase 8's bars (the parameters after the step: the gradient
    bar carried through Momentum's first step, lr x g); the task-aligned
    assignment on each device's own outputs equal at every anchor clear of
    a tie (the rule of ppyoloe-cpu: its deciding metrics, the gt's k-th
    metric and the best two candidates, further apart on the CPU than
    twice the devices' largest metric difference)."""
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.vision.models import PPYOLOECriterion
    from paddle_tpu_torch.vision.models.detection import ppyoloe as port_pp
    tag = "ppyoloe-train-cpu"
    gm_, cm = _small_ppyoloe(torch, "cuda", 5), _small_ppyoloe(torch, "cpu",
                                                               6)
    _randomize_bn(torch, gm_, 25)
    cm.load_state_dict({k: v.cpu() for k, v in gm_.state_dict().items()})
    ds = _detection_set(2, 160, 160, seed=43, pixels=True)
    batches = {dev: ([x], labels) for dev, (x, *labels) in (
        (dev, ds.batch(torch, slice(0, 2), dev)) for dev in ("cuda", "cpu"))}
    got = {}
    with torch.no_grad():
        for dev, m in (("cuda", gm_), ("cpu", cm)):
            (x,), (gb, gc, gmask) = batches[dev]
            cls_logits, _, boxes = m(x)
            anchors, _ = m._last_anchors
            scores = torch.sigmoid(cls_logits)
            metric, iou, valid = port_pp.tal_metric(
                scores, boxes, anchors, gb, gc, gmask)
            assigned, fg, _ = port_pp.task_aligned_assign(
                scores, boxes, anchors, gb, gc, gmask)
            got[dev] = [t.cpu() for t in (metric, valid, assigned, fg)]
    mg, _, ag, fgg = got["cuda"]
    mc, vc, ac, fgc = got["cpu"]
    err = (mg - mc).abs().max().item()
    band = 2 * err
    # a tie: the anchor's metric within the band of its gt's k-th metric,
    # or its best two candidates within the band of each other
    k = min(13, mc.shape[1])
    thresh = mc.transpose(1, 2).topk(k, dim=-1).values[..., -1]
    near_k = ((mc - thresh[:, None, :]).abs() <= band) & vc
    top2 = mc.topk(2, dim=-1).values
    near = near_k.any(-1) | ((top2[..., 0] - top2[..., 1]) <= band) & (
        top2[..., 0] > 0)
    clear = ~near
    same = (ag == ac) & (fgg == fgc)
    check(bool(same[clear].all()), f"{tag}: the assignment differs at "
          f"{int((~same & clear).sum())} anchors clear of a tie")
    log(f"{tag}: task-aligned assignment, cuda vs cpu on each one's own "
        f"outputs: metrics {err:.3e} apart; equal at all "
        f"{int(clear.sum())} anchors clear of a tie, {int(near.sum())} "
        f"within 2 x {err:.1e} of one ({int((~same).sum())} differ); "
        f"{int(fgc.sum())} foreground anchors on the CPU")
    crit = PPYOLOECriterion(gm_)
    ccrit = PPYOLOECriterion(cm)
    engines = {"cuda": Engine(gm_, crit, _ppyoloe_momentum(gm_)),
               "cpu": Engine(cm, ccrit, _ppyoloe_momentum(cm))}

    class _ByDevice:
        """The criterion of the model on the outputs' device."""

        def __call__(self, *a):
            return (crit if a[0].is_cuda else ccrit)(*a)
    r = _cross_device_step(tag, "PP-YOLOE small, 2 x 160 x 160, f32, "
                           "Momentum(0.00125, 0.9, L2 5e-4)",
                           {"cuda": gm_, "cpu": cm}, engines, batches,
                           _ByDevice(), linear_step=True)
    r.update(metric_err=err, ties=int(near.sum()))
    return r


# -- the captured training step (phase train-graph) ----------------------------

# what a profile counts as the host launching a CUDA graph
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# kernel-node name fragments of a GPT step's graph: each flash kernel once a
# layer, #10 once a step
GPT_GRAPH_KERNELS = (("flash_attention_fwd", "flash_fwd_tc_kernel"),
                     ("flash_attention_bwd_dq", "flash_bwd_dq_tc_kernel"),
                     ("flash_attention_bwd_dkv", "flash_bwd_dkv_tc_kernel"))


class _TwinWatch:
    """Over a run: the calls of every plain twin of the kernel modules
    (each public function whose name ends in ``_plain``, and the optimizer
    module's imported ``adamw_update_plain``), patched for the run."""

    def __enter__(self):
        from paddle_tpu_torch.ops.kernels import (conv_bn_act,
                                                  flash_attention,
                                                  fused_adamw, fused_ln)
        from paddle_tpu_torch.optimizer import optimizer as om
        self.calls, self._saved = {}, []
        # the paged decode's module by path: the package attribute named
        # flash_decode is the dense decode's wrapper
        for mod in (conv_bn_act, flash_attention, _paged_module(),
                    fused_adamw, fused_ln, om):
            for name in dir(mod):
                fn = getattr(mod, name)
                if name.endswith("_plain") and not name.startswith("_") \
                        and callable(fn):
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def counted(*args, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _graph_node_names(torch, g):
    """The nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``, as ``_graph_nodes`` reads them."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(err, what):
        check(err == 0, f"CUDA driver {what} returned error {err}")

    graph = vp(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2",
                         cu.cuGraphKernelNodeGetParams)
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            out.append(f"<node type {kind.value}>")
            continue
        params = (vp * 16)()
        ok(get_params(vp(node), params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(params[0])),
               "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(params[7])),
               "cuKernelGetName")
        out.append(name.value.decode())
    return out


def _recording(eng, kind):
    """The Engine's recording of ``kind`` ("train", "grad", "apply")."""
    recs = [r for k, r in eng._recorded.items()
            if (k[0][0] if isinstance(k[0], tuple) else k[0]) == kind]
    check(len(recs) == 1 and recs[0].graph is not None,
          f"train-graph: the Engine holds {len(recs)} recorded {kind} steps")
    return recs[0]


def _snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def _compare_states(tag, what, eager, captured, start,
                    zero_grads=("k_proj.bias",), noise_bar=None):
    """Parameters (and buffers) of the eager model against the captured
    one's: bit for bit, else PERF.md §2's training-step bar with the
    reason logged: each leaf's update since ``start`` within 5e-2
    relative L2 of the eager one's (or within 1e-5 absolute). A leaf
    named with a suffix of ``zero_grads`` (the key bias: zero in exact
    arithmetic, its gradient rounding noise, which Adam still turns into
    steps of up to lr) is held to ``noise_bar`` absolute instead, where
    given. -> "bit for bit" or the worst relative update difference."""
    pc = list(captured.parameters())
    same = all(torch_equal(a, b) for a, b in zip(eager.parameters(), pc))
    bufs_same = all(torch_equal(a, b) for a, b in zip(eager.buffers(),
                                                      captured.buffers()))
    if same and bufs_same:
        return "bit for bit"
    worst, differ = 0.0, []
    for (n, a), b, p0 in zip(eager.named_parameters(), pc, start):
        diff = (a - b).abs().max().item()
        if diff:
            differ.append(n)
        if noise_bar is not None and n.endswith(tuple(zero_grads)):
            check(diff <= noise_bar, f"{tag}: {what}: {n} (its gradient "
                  f"zero in exact arithmetic) differs by {diff} > "
                  f"{noise_bar}")
            continue
        rel = (a - b).float().norm().item() / max(
            (a - p0).float().norm().item(), 1e-30)
        check(rel <= 5e-2 or diff <= 1e-5,
              f"{tag}: {what}: {n}'s update differs by {rel} relative L2 "
              f"between the eager and the captured step")
        worst = max(worst, rel if diff > 1e-5 else 0.0)
    log(f"{tag}: {what}: not bit for bit: {len(differ)} leaves differ "
        f"({differ[:4]}{' ...' if len(differ) > 4 else ''}; PyTorch's and "
        f"cuDNN's kernels that add with atomics, an embedding's backward or "
        f"a convolution's weight gradient, sum in another order each run); "
        f"within PERF.md §2's bar: the worst leaf's update differs by "
        f"{worst:.3e} relative L2 (leaves within 1e-5 absolute count 0); "
        f"buffers {'equal' if bufs_same else 'not equal'} bit for bit")
    return worst


def _resync(me, ee, mc, ce):
    """The captured model and optimizer state set to the eager one's, in
    place (a recorded step reads them where they are)."""
    import torch
    with torch.no_grad():
        for a, b in zip(mc.parameters(), me.parameters()):
            a.copy_(b)
        for a, b in zip(mc.buffers(), me.buffers()):
            a.copy_(b)
        for name, slots in ee.optimizer._state.items():
            for k, t in slots.items():
                ce.optimizer._state[name][k].copy_(t)


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def _turns(torch, engines, inputs, labels, steps=10):
    """ms a step of each engine, timed in turns (eager, captured,
    captured, eager), ``steps`` steps a turn ending in one sync."""
    import statistics
    out = {k: [] for k in engines}
    for key in ("eager", "captured", "captured", "eager"):
        eng = engines[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.train_batch(inputs, labels)
        torch.cuda.synchronize()
        out[key].append((time.perf_counter() - t0) / steps * 1e3)
    return {k: dict(turns=v, ms=statistics.mean(v)) for k, v in out.items()}


def _mode_profile(torch, tag, eng, inputs, labels, groups):
    prof = profile_grouped(torch, tag, "one training step",
                           lambda: eng.train_batch(inputs, labels), groups)
    return dict(busy_share=prof["busy_share"],
                launch_calls=prof["launch_calls"],
                graph_launches=prof.get("graph_launches", 0))


def _graph_pair(torch, tag, make, inputs, labels, groups, steps=5,
                linear=False, schedule=None, lockstep=True, expect=None,
                compare=None):
    # linear: a Momentum step (lr times the gradient), not Adam's
    """The eager and the captured Engine of one path from the same
    weights, batch and generator state: ``steps`` steps each, the
    captured one's first eager, its second recorded then replayed, the
    rest replayed; every step's loss and the parameters after it held
    eager against captured (``_compare_states``); ``schedule``: a
    function of the step giving both optimizers that lr. ``lockstep``:
    both Engines live at once, compared after every step, then timed in
    turns; else (GPT-1.3B: two would not fit the card with the graph's
    pool) the eager run first, its losses and parameters kept, then the
    captured one, each timed alone. ``expect``: {wrapper: launches a
    step} the recording must make, and no plain twin. ``compare``: the
    lockstep comparison in ``_compare_states``'s place (its arguments, its
    result). Peak memory of each (max_memory_allocated over its first
    steps, above what was allocated before it was built, the other
    Engine's resident state taken out) and reserved memory; one profiled
    step each (busy share, host launches, graph launches)."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    res = {}
    gib = 2 ** 30

    def set_lr(eng, i):
        if schedule is not None:
            eng.optimizer._lr = schedule(i)

    def noise_bar(n):
        """2 * lr an Adam update over ``n`` steps (None for Momentum)."""
        if linear:
            return None
        return 2 * sum(schedule(i) if schedule else ee_lr
                       for i in range(n))

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    me, ee = make(False)
    ee_lr = ee.optimizer.get_lr()
    start = _snapshot(me)
    e_loss, c_loss = [], []
    set_lr(ee, 0)
    e_loss.append(ee.train_batch(inputs, labels)[0].item())
    res["eager_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / gib
    e_res = torch.cuda.memory_allocated() - base
    if not lockstep:
        for i in range(1, steps):
            set_lr(ee, i)
            e_loss.append(ee.train_batch(inputs, labels)[0].item())
        want = _snapshot(me)
        timed = {}
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                ee.train_batch(inputs, labels)
            torch.cuda.synchronize()
            timed.setdefault("eager", []).append(
                (time.perf_counter() - t0) / 10 * 1e3)
        res["eager_profile"] = _mode_profile(torch, f"{tag} eager", ee,
                                             inputs, labels, groups)
        del me, ee
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        e_res = 0
    torch.cuda.reset_peak_memory_stats()
    mc, ce = make(True)
    check(ce.captures, f"{tag}: the Engine does not capture "
          f"({ce.eager_reason})")
    for a, b in zip(start, mc.parameters()):
        check(torch_equal(a, b), f"{tag}: the two builds' weights differ")
    c_launches = dict.fromkeys(_read_launches(), 0)
    for i in range(steps):
        set_lr(ce, i)
        n0 = _read_launches()
        if i == 1:
            with _TwinWatch() as twins:
                c_loss.append(ce.train_batch(inputs, labels)[0].item())
            rec = {n: c - n0[n] for n, c in _read_launches().items() if
                   c - n0[n]}
            check(not twins.calls, f"{tag}: the recording ran plain twins "
                  f"{twins.calls}")
            if expect is not None:
                check(rec == expect, f"{tag}: the recorded step launched "
                      f"{rec}, want {expect}")
            res["recorded_launches"] = rec
            res["captured_peak_gib"] = (torch.cuda.max_memory_allocated()
                                        - base - e_res) / gib
        else:
            c_loss.append(ce.train_batch(inputs, labels)[0].item())
        for n, c in _read_launches().items():
            c_launches[n] += c - n0[n]
        if lockstep and i:
            set_lr(ee, i)
            e_loss.append(ee.train_batch(inputs, labels)[0].item())
        if lockstep:
            state = (compare or _compare_states)(
                tag, f"step {i + 1}" + (f" at lr {schedule(i):.3e}"
                                        if schedule else ""), me, mc, start,
                noise_bar=noise_bar(i + 1))
            res.setdefault("states", []).append(state)
            if state != "bit for bit":
                # the next step from the eager state on both: each step is
                # held to the bar alone, as §2 holds one step
                _resync(me, ee, mc, ce)
                start = _snapshot(me)
    # the wrappers' counts over the captured Engine's steps: its eager
    # first step and its recording (a replay launches through the graph)
    res["launches"] = c_launches
    check(all(c_launches[n] == 2 * k for n, k in (expect or {}).items()),
          f"{tag}: the captured Engine's wrappers counted {c_launches}")
    res["reserved_gib"] = torch.cuda.memory_reserved() / gib
    if not lockstep:
        for a, b in zip(want, mc.parameters()):
            if not torch_equal(a, b):
                break
        else:
            res["states"] = ["bit for bit"]
        if "states" not in res:
            class _Snap(torch.nn.Module):
                def __init__(self, ps):
                    super().__init__()
                    self.ps = torch.nn.ParameterList(
                        [torch.nn.Parameter(p, requires_grad=False)
                         for p in ps])
            res["states"] = [_compare_states(tag, f"after {steps} steps",
                                             _Snap(want), mc, start,
                                             noise_bar=noise_bar(steps))]
        del want
    bitwise = e_loss == c_loss
    rel = max(abs(a - b) / abs(a) for a, b in zip(e_loss, c_loss))
    check(all(math.isfinite(x) for x in e_loss + c_loss),
          f"{tag}: losses eager {e_loss} captured {c_loss}")
    check(bitwise or rel <= 1e-4, f"{tag}: losses eager {e_loss} captured "
          f"{c_loss} ({rel} relative)")
    res.update(eager_losses=e_loss, captured_losses=c_loss,
               losses_bitwise=bitwise, loss_rel=rel)
    if lockstep:
        res["ms"] = _turns(torch, {"eager": ee, "captured": ce}, inputs,
                           labels)
        res["eager_profile"] = _mode_profile(torch, f"{tag} eager", ee,
                                             inputs, labels, groups)
    else:
        tc = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                ce.train_batch(inputs, labels)
            torch.cuda.synchronize()
            tc.append((time.perf_counter() - t0) / 10 * 1e3)
        res["ms"] = {"eager": dict(turns=timed["eager"],
                                   ms=sum(timed["eager"]) / 2),
                     "captured": dict(turns=tc, ms=sum(tc) / 2)}
    res["captured_profile"] = _mode_profile(torch, f"{tag} captured", ce,
                                            inputs, labels, groups)
    ep, cp = res["eager_profile"], res["captured_profile"]
    log(f"{tag}: eager vs captured, {steps} steps from the same start: "
        f"losses {'bit for bit' if bitwise else f'within {rel:.2e}'} "
        f"({c_loss[0]:.6f} -> {c_loss[-1]:.6f}), parameters "
        f"{res['states'][-1] if isinstance(res['states'][-1], str) else 'within the bars'}; "
        f"ms a step {res['ms']['eager']['ms']:.3f} vs "
        f"{res['ms']['captured']['ms']:.3f} (turns "
        f"{[round(x, 3) for x in res['ms']['eager']['turns']]} vs "
        f"{[round(x, 3) for x in res['ms']['captured']['turns']]}"
        f"{'' if lockstep else ', each alone'}); busy share "
        f"{ep['busy_share']} vs {cp['busy_share']}; host launches a step "
        f"{ep['launch_calls']} cudaLaunchKernel vs {cp['launch_calls']} + "
        f"{cp['graph_launches']} cudaGraphLaunch; peak memory "
        f"{res['eager_peak_gib']:.2f} vs {res['captured_peak_gib']:.2f} "
        f"GiB, reserved {res['reserved_gib']:.2f} GiB; the recording "
        f"launched {res['recorded_launches']}, no twin")
    res["engines"] = (me, ee, mc, ce) if lockstep else (mc, ce)
    return res


def _gpt_graph_check(torch, tag, ce, ee, inputs, labels, layers):
    """The GPT step's graph: each flash kernel once a layer, #10 once, and
    one replay (train_batch on the captured Engine) raises nothing under
    the sync debug mode "error" (the eager Engine then takes the same
    step, so the two stay in step)."""
    nodes = _graph_node_names(torch, _recording(ce, "train").graph)
    counts = {w: sum(frag in n for n in nodes)
              for w, frag in GPT_GRAPH_KERNELS}
    counts["fused_adamw_multi_update"] = sum("adamw_kernel" in n
                                             for n in nodes)
    want = {w: layers for w, _ in GPT_GRAPH_KERNELS}
    want["fused_adamw_multi_update"] = 1
    check(counts == want, f"{tag}: the graph holds {counts}, want {want}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ce.train_batch(inputs, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ee.train_batch(inputs, labels)
    torch.cuda.synchronize()
    kinds = {}
    for n in nodes:
        k = n if n.startswith("<") else "kernel"
        kinds[k] = kinds.get(k, 0) + 1
    log(f"{tag}: the recorded step's graph: {len(nodes)} nodes {kinds}; "
        f"{counts} of the port's kernels; one replay under the sync debug "
        f"mode 'error' raised nothing")
    return dict(nodes=len(nodes), kinds=kinds, kernels=counts)


def _lm_batches(vocab, k, b, s, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, vocab, (k, b, s))).cuda(),
            torch.from_numpy(rng.integers(0, vocab, (k, b, s))).cuda())


def _graph_multi(torch, tag, me, ee, mc, ce, cfg):
    """train_batch_multi with K = 10 on the captured Engine against 10
    train_batch calls on the eager one, both from the same state: losses
    and parameters, and the multi call's ms a step."""
    ids, labels = _lm_batches(cfg.vocab_size, 10, 8, 1024, seed=1)
    start = _snapshot(me)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, outs = ce.train_batch_multi([ids], [labels])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 10 * 1e3
    check(outs is None and tuple(losses.shape) == (10,),
          f"{tag}: train_batch_multi returned {tuple(losses.shape)}, {outs}")
    got = losses.tolist()
    want = [ee.train_batch([ids[i]], [labels[i]])[0].item()
            for i in range(10)]
    rel = max(abs(a - b) / abs(a) for a, b in zip(want, got))
    check(got == want or rel <= 1e-4, f"{tag}: multi losses {got} vs "
          f"{want}")
    state = _compare_states(tag, "K = 10 multi vs 10 train_batch calls",
                            me, mc, start)
    check(ce._step == ee._step and ce._opt_step == ee._opt_step,
          f"{tag}: counters {ce._step}/{ce._opt_step} vs "
          f"{ee._step}/{ee._opt_step}")
    log(f"{tag}: train_batch_multi K = 10 vs 10 train_batch calls: losses "
        f"{'bit for bit' if got == want else f'within {rel:.2e}'}, "
        f"parameters {state if isinstance(state, str) else 'within bars'};"
        f" {ms:.3f} ms a step in the multi call (no host sync in it)")
    return dict(ms=ms, losses_bitwise=got == want, state=state)


def _graph_accum(torch, tag, cfg):
    """Accumulation on GPT-345M in f32: 4 micro-batches of 2 x 1024 on a
    captured Engine against one 8 x 1024 step on an eager one, two
    windows (the second's apply step replayed), held to PERF.md §2's
    training-step bars: each window's mean loss within 1e-4 relative;
    after the first update every element within 1e-5, or 2 * lr where
    Adam's second moment says every gradient of the element stayed below
    1e-6 (a step function of g near eps); the second update, where Adam's
    m can cancel between the two gradients and magnify their rounding,
    within 5e-2 relative L2 of the full step's update, leaf by leaf. The
    apply step's graph holds #10 once, and its replay launched it once."""
    ids, labels = _lm_batches(cfg.vocab_size, 2, 8, 1024, seed=2)
    mf, ef = _train_engine(torch, cfg, "cuda", capture=False)
    ma, ea = _train_engine(torch, cfg, "cuda", capture=True)
    worst, steep_worst, upd_worst, rels = 0.0, 0.0, 0.0, []
    for w in range(2):
        before = _snapshot(mf)
        full = ef.train_batch([ids[w]], [labels[w]])[0].item()
        micro = []
        for j in range(4):
            sl = slice(2 * j, 2 * j + 2)
            if w == 1 and j == 3:
                n0 = _read_launches()["fused_adamw_multi_update"]
            loss, _, applied = ea.train_batch_accum(
                [ids[w][sl]], [labels[w][sl]], apply_update=j == 3)
            micro.append(loss.item())
            check(applied == (j == 3), f"{tag}: applied {applied}")
        if w == 1:
            launched = _read_launches()["fused_adamw_multi_update"] - n0
            check(launched == 1, f"{tag}: the recorded apply step launched "
                  f"#10 {launched} times")
        rel = abs(sum(micro) / 4 - full) / abs(full)
        rels.append(rel)
        check(rel <= 1e-4, f"{tag}: window {w}: mean micro loss "
              f"{sum(micro) / 4} vs {full}")
        opt = ef.optimizer
        bc2 = 1.0 - opt._beta2 ** ef._opt_step
        lr = opt.get_lr()
        for (n, a), b, p0 in zip(mf.named_parameters(), ma.parameters(),
                                 before):
            if w == 1 and n.endswith("k_proj.bias"):
                # zero in exact arithmetic: rounding noise that Adam turns
                # into steps of up to lr
                check((a - b).abs().max().item() <= 4 * lr,
                      f"{tag}: window 1: {n} differs by more than 2 * lr "
                      f"an update")
                continue
            if w == 1:
                upd = (a - b).norm().item() / max((a - p0).norm().item(),
                                                  1e-30)
                check(upd <= 5e-2, f"{tag}: window 1: {n}'s update differs "
                      f"by {upd} relative L2")
                upd_worst = max(upd_worst, upd)
                continue
            diff = (a - b).abs()
            steep = (opt._state[n]["v"] / bc2).sqrt() < 1e-6
            flat = diff[~steep].max().item() if (~steep).any() else 0.0
            sharp = diff[steep].max().item() if steep.any() else 0.0
            check(flat <= 1e-5 and sharp <= 2 * lr,
                  f"{tag}: window 0: {n} differs by {flat} ({sharp} where "
                  f"|g| < 1e-6)")
            worst, steep_worst = max(worst, flat), max(steep_worst, sharp)
        del before
    nodes = _graph_node_names(torch, _recording(ea, "apply").graph)
    n_adamw = sum("adamw_kernel" in n for n in nodes)
    check(n_adamw == 1, f"{tag}: the apply step's graph holds #10 "
          f"{n_adamw} times")
    check(_recording(ea, "grad").graph is not None, f"{tag}: no grad graph")
    log(f"{tag}: 4 x (2 x 1024) accumulated vs one 8 x 1024 step, f32, two "
        f"windows: mean loss within {max(rels):.2e} relative; after the "
        f"first update parameters within {worst:.2e} ({steep_worst:.2e} "
        f"where Adam's v says |g| < 1e-6), the second update within "
        f"{upd_worst:.2e} relative L2 at worst; the apply step's graph "
        f"({len(nodes)} nodes) holds #10 once and its replay launched it "
        f"once")
    del mf, ef, ma, ea
    torch.cuda.empty_cache()
    return dict(loss_rel=max(rels), param_err=worst, update_rel=upd_worst)


def _lenet_fit(torch, tag, train, capture):
    """One LeNet Model.fit (2 epochs at batch 256, no shuffle) from seed
    0's weights -> (Model, per-batch losses, s an epoch, peak GiB)."""
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    net = LeNet(device="cuda", generator=seed(0, device="cuda"))
    m = Model(net)
    m.prepare(Adam(1e-3, parameters=net.parameters(), fused_kernel=True),
              nn.CrossEntropyLoss(), capture=capture)
    losses = []

    class Rec(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"][0])

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.fit(train, epochs=2, batch_size=256, shuffle=False, verbose=0,
          callbacks=[Rec()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(m._engine.captures == capture, f"{tag}: Engine(capture="
          f"{capture}) captures {m._engine.captures}")
    return m, losses, wall / 2, torch.cuda.max_memory_allocated() / 2 ** 30


def _graph_lenet(torch, tag):
    """LeNet through Model.fit, eager against captured from the same
    weights: 2 epochs of MNIST(mode="train") at batch 256, no shuffle
    (23 full batches and a tail of 112 an epoch: the tail's own recording
    in the second epoch), Adam(1e-3, fused_kernel=True): every batch's
    loss, the parameters after, the seconds an epoch, then one
    Model.train_batch of each profiled. cuDNN runs its deterministic
    algorithms in both fits (its default weight gradient adds with
    atomics in another order each run, and 48 steps would carry that
    apart), so the two can agree bit for bit."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    train = MNIST(mode="train")
    out, models = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode, capture in (("eager", False), ("captured", True)):
            models[mode], losses, epoch_s, peak = _lenet_fit(
                torch, tag, train, capture)
            out[mode] = dict(losses=losses, epoch_s=epoch_s, peak_gib=peak)
        start = _snapshot(LeNet(device="cuda",
                                generator=seed(0, device="cuda")))
        state = _compare_states(tag, "after 2 epochs",
                                models["eager"].network,
                                models["captured"].network, start)
        el, cl = out["eager"]["losses"], out["captured"]["losses"]
        rel = max(abs(a - b) / abs(a) for a, b in zip(el, cl))
        check(len(el) == len(cl) == 48 and (el == cl or rel <= 1e-4),
              f"{tag}: losses eager {el} captured {cl}")
        xb, yb = (t.cuda() for t in next(iter(
            models["eager"]._loaders["train"]))[:2])
        for mode in ("eager", "captured"):
            mm = models[mode]
            prof = profile_grouped(
                torch, f"{tag} {mode}", "one Model.train_batch",
                lambda: mm.train_batch([xb], [yb]), LM_TRAIN_GROUPS)
            out[mode].update(busy_share=prof["busy_share"],
                             launch_calls=prof["launch_calls"],
                             graph_launches=prof["graph_launches"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"{tag}: Model.fit 2 epochs eager vs captured (cuDNN "
        f"deterministic): 48 losses "
        f"{'bit for bit' if el == cl else f'within {rel:.2e}'}, parameters "
        f"{state if isinstance(state, str) else 'within the bars'}; s an "
        f"epoch {out['eager']['epoch_s']:.3f} vs "
        f"{out['captured']['epoch_s']:.3f}; busy {out['eager']['busy_share']}"
        f" vs {out['captured']['busy_share']}; host launches a train_batch "
        f"{out['eager']['launch_calls']} vs "
        f"{out['captured']['launch_calls']} + "
        f"{out['captured']['graph_launches']} graph; peak "
        f"{out['eager']['peak_gib']:.3f} vs "
        f"{out['captured']['peak_gib']:.3f} GiB")
    out["state"] = state
    return out


def phase_train_graph(torch):
    """Phase train-graph: each training path's step recorded as a CUDA
    graph by the Engine, against the eager step from the same weights,
    batch and generator state (see the module docstring)."""
    from paddle_tpu_torch.nlp.ernie import _resolve_config as ernie_config
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    from paddle_tpu_torch.optimizer.lr import LinearWarmup
    out = {}
    flash3 = {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 24,
              "flash_attention_bwd_dkv": 24}
    for tag, drop in (("gpt3-345M", 0.0), ("gpt3-345M dropout 0.1", 0.1)):
        cfg = _resolve_config("gpt3-345M", hidden_dropout_prob=drop,
                              attention_probs_dropout_prob=drop)
        ids, labels = _batch(cfg, 8, 1024, "cuda")
        sched = None
        if not drop:
            # a warm-up: lr moves between the replays
            warm = LinearWarmup(1e-4, warmup_steps=5, start_lr=0.0,
                                end_lr=1e-4)
            lrs = []
            for _ in range(5):
                lrs.append(float(warm()))
                warm.step()
            sched = lambda i: lrs[i]  # noqa: E731
        r = _graph_pair(
            torch, f"train-graph {tag}",
            lambda cap, cfg=cfg: _train_engine(torch, cfg, "cuda",
                                               amp=torch.bfloat16,
                                               capture=cap),
            [ids], [labels], LM_TRAIN_GROUPS, schedule=sched,
            expect=dict(flash3, fused_adamw_multi_update=1))
        me, ee, mc, ce = r.pop("engines")
        if not drop:
            check(len(set(lrs)) == 5, f"train-graph: lrs {lrs}")
            r["graph"] = _gpt_graph_check(torch, f"train-graph {tag}", ce,
                                          ee, [ids], [labels],
                                          cfg.num_hidden_layers)
            r["multi"] = _graph_multi(torch, f"train-graph {tag}", me, ee,
                                      mc, ce, cfg)
            r["lrs"] = lrs
            log(f"train-graph {tag}: the 5 steps ran at lr {lrs} (a linear "
                f"warm-up), each replay's parameters bit for bit or within "
                f"the bars of the eager step's: {r['states']}")
        out[tag] = r
        del me, ee, mc, ce
        torch.cuda.empty_cache()
    cfg = _resolve_config("gpt3-345M", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    out["accum"] = _graph_accum(torch, "train-graph gpt3-345M accumulation",
                                cfg)
    ecfg = ernie_config("ernie-3.0-base-zh", hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0, fused_ln=True)
    inputs, labels = _ernie_batch(ecfg.vocab_size, 32, 512, "cuda")
    r = _graph_pair(
        torch, "train-graph ernie-3.0-base",
        lambda cap: _ernie_engine(torch, ecfg, "cuda", amp=torch.bfloat16,
                                  capture=cap),
        inputs, labels, LM_TRAIN_GROUPS,
        expect={"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                "flash_attention_bwd_dkv": 12, "fused_adamw_multi_update": 1,
                "fused_add_layer_norm_y_fwd": 24,
                "fused_add_layer_norm_y_bwd": 24})
    r.pop("engines")
    out["ernie-3.0-base"] = r
    torch.cuda.empty_cache()
    cfg13 = _resolve_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    ids, labels = _batch(cfg13, 4, 1024, "cuda")
    r = _graph_pair(
        torch, "train-graph gpt3-1.3B",
        lambda cap: _train_engine(torch, cfg13, "cuda", amp=torch.bfloat16,
                                  capture=cap),
        [ids], [labels], LM_TRAIN_GROUPS, lockstep=False,
        expect=dict(flash3, fused_adamw_multi_update=1))
    r.pop("engines")
    out["gpt3-1.3B"] = r
    torch.cuda.empty_cache()
    x, y = _resnet_train_batch(torch, 256, 224)
    r = _graph_pair(
        torch, "train-graph resnet50",
        lambda cap: _resnet_train_engine(torch, "cuda", amp="bfloat16",
                                         capture=cap),
        [x], [y], TRAIN_GROUPS, linear=True,
        expect={"fused_conv1x1_bn_act": 17})
    r.pop("engines")
    out["resnet50"] = r
    del x, y
    torch.cuda.empty_cache()
    out["lenet"] = _graph_lenet(torch, "train-graph lenet")
    torch.cuda.empty_cache()
    return out


# -- the classification zoo and vision.ops ------------------------------------

# the served zoo: (factory, input size); every model at its published
# width with 1000 classes
ZOO_SERVE = (("vgg16", 224), ("alexnet", 224), ("squeezenet1_1", 224),
             ("mobilenet_v1", 224), ("mobilenet_v2", 224),
             ("mobilenet_v3_large", 224), ("densenet121", 224),
             ("shufflenet_v2_x1_0", 224), ("googlenet", 224),
             ("inception_v3", 299))
# device kernels of a zoo forward or step, grouped by name (first match
# wins)
ZOO_GROUPS = (
    ("#10 (adamw_kernel)", ("adamw_kernel",)),
    ("cuDNN and depthwise convolutions",
     ("fprop", "dgrad", "wgrad", "implicit", "conv", "winograd", "cudnn",
      "nhwc", "nchw", "fft", "dse::", "pointwise_mult_and_sum")),
    ("GEMMs (classifiers)", ("gemm", "cutlass", "cublas", "sm90_xmma")),
    ("elementwise and BatchNorm (eager BatchNorm, activations, pools, "
     "concatenation, copies, the loss)",
     ("elementwise", "reduce", "copy", "fill", "cat", "index", "softmax",
      "pool", "batch_norm", "nll", "gather", "scatter")),
)
# the leaves of train-mode MobileNetV2 whose gradient is zero in exact
# arithmetic: each projection's BatchNorm bias only shifts the input of a
# convolution whose own train-mode BatchNorm removes the shift again
MOBILENET_ZERO_GRADS = ("conv.2.bn.bias", "features.1.conv.1.bn.bias")
# the share of elements (outside MOBILENET_ZERO_GRADS) an Adam step may
# put more than 1e-5 (and at most 2 * lr) apart: Adam moves an element by
# lr times the sign of its gradient, which at a ReLU6 kink can lie within
# rounding of 0; tests/test_torch_zoo.py measured 1.1e-4 against the JAX
# package over two steps
ZOO_APART = 5e-4


def _zoo_model(torch, name, device, weight_seed, **kw):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision import models
    return getattr(models, name)(
        device=device, generator=seed(weight_seed, device=device), **kw)


def phase_zoo_serve(torch):
    """Phase zoo-serve: each model of ZOO_SERVE at 1000 classes, weights
    from seed 0 with random BatchNorm statistics, eval, f32 NCHW, batch 64
    from numpy seed i under inference_mode: no kernel of the port launched
    (its convolutions are cuDNN's); images/s and ms a forward over 10
    forwards ending in one sync, peak memory above the model's weights,
    one forward profiled (busy share, device time by kind); then the
    model's first 2 images on the card and on the CPU from the same
    weights: logits within 1e-3 of their max-abs, top-1 equal where the
    CPU's top two lie further apart than twice the devices' difference.
    Then mobilenet_v2 through Model.evaluate and Model.predict over
    io.DataLoader (SyntheticImageNet, 512 images, batch 64, 2 workers):
    predict's logits equal a direct forward's on the same images."""
    b = 64
    out = {}
    gib = 2 ** 30
    for i, (name, hw) in enumerate(ZOO_SERVE):
        tag = f"zoo-serve {name}"
        torch.cuda.empty_cache()
        model = _zoo_model(torch, name, "cuda", 0).eval()
        _randomize_bn(torch, model, 30 + i)
        x = _images(torch, b, hw, hw, seed=i)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits, _, ips, ms = _serve(torch, tag, model, x, {})
        peak = (torch.cuda.max_memory_allocated() - base) / gib
        check(tuple(logits.shape) == (b, 1000)
              and bool(torch.isfinite(logits).all()),
              f"{tag}: logits {tuple(logits.shape)} not finite [{b}, 1000]")
        prof = _inference_profile(torch, tag, model, x, ZOO_GROUPS)
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        cm = _zoo_model(torch, name, "cpu", 1).eval()
        cm.load_state_dict(state)
        with torch.inference_mode():
            got, want = model(x[:2]), cm(x[:2].cpu())
        err = _close_rel(f"{tag} cuda vs cpu", got, want, 1e-3)
        clear, differ, _ = _top1_clear(f"{tag} cuda vs cpu", got, want)
        params = sum(p.numel() for p in model.parameters())
        log(f"{tag}: {params / 1e6:.2f} M parameters, f32, batch {b} x "
            f"{hw} x {hw}: {ips:.1f} images/s, {ms:.3f} ms a forward (10 "
            f"forwards, one sync), no kernel of the port; peak "
            f"{peak:.2f} GiB above the weights; cuda vs cpu on 2 images: "
            f"logits {err:.3e} of their max-abs, top-1 equal ({clear} of 2 "
            f"clear of a tie, {differ} differ)")
        out[name] = dict(hw=hw, batch=b, params=params, images_per_s=ips,
                         ms_per_forward=ms, peak_gib=peak,
                         busy_share=prof["busy_share"],
                         groups=prof.get("groups"), cpu_err=err)
        del model, cm, x, logits, state
    out["mobilenet_v2 evaluate"] = _zoo_evaluate(torch)
    torch.cuda.empty_cache()
    return out


def _zoo_evaluate(torch):
    """mobilenet_v2 through Model.evaluate and Model.predict over
    io.DataLoader."""
    import numpy as np
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision.datasets import SyntheticImageNet
    tag, b, n = "zoo-serve mobilenet_v2 evaluate", 64, 512
    net = _zoo_model(torch, "mobilenet_v2", "cuda", 0)
    _randomize_bn(torch, net, 34)
    model = Model(net)
    model.prepare(loss=nn.CrossEntropyLoss(), metrics=Accuracy(topk=(1, 5)))
    ds = SyntheticImageNet(n=n, image_size=224)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = model.evaluate(ds, batch_size=b, num_workers=2, verbose=0)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = model.predict(ds, batch_size=b, num_workers=2,
                         stack_outputs=True)
    pred_s = time.perf_counter() - t0
    launches = {k: v for k, v in _read_launches().items() if v}
    check(not launches, f"{tag}: kernels of the port launched {launches}")
    check(math.isfinite(ev["loss"][0])
          and 0.0 <= ev["acc_top1"] <= ev["acc_top5"] <= 1.0,
          f"{tag}: evaluate {ev}")
    check(pred[0].shape == (n, 1000) and bool(np.isfinite(pred[0]).all()),
          f"{tag}: predict gave {pred[0].shape}")
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(b)])).cuda()
    with torch.inference_mode():
        direct = net(x).cpu()
    err = _close_rel(f"{tag} predict vs a direct forward",
                     torch.from_numpy(pred[0][:b]), direct, 1e-5)
    log(f"{tag}: evaluate over {n} images {ev} in {eval_s:.3f} s "
        f"({n / eval_s:.1f} images/s, the loader included); predict "
        f"{pred[0].shape} in {pred_s:.3f} s ({n / pred_s:.1f} images/s), "
        f"its first batch {err:.3e} of its max-abs from a direct forward")
    return dict(evaluate=ev, eval_images_per_s=n / eval_s,
                predict_images_per_s=n / pred_s, predict_err=err)


def _mobilenet_adamw(net):
    """AdamW(1e-3, weight_decay=1e-4) on #10: one launch a step over every
    f32 leaf."""
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(1e-3, parameters=net.named_parameters(), weight_decay=1e-4,
                 fused_kernel=True)


def _mobilenet_engine(torch, device, capture, weight_seed=0):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi import Engine
    net = _zoo_model(torch, "mobilenet_v2", device, weight_seed)
    return net, Engine(net, nn.CrossEntropyLoss(), _mobilenet_adamw(net),
                       capture=capture)


def _apart_compare(tag, what, eager, captured, start, zero_grads=(),
                   noise_bar=None):
    """A captured Adam step against the eager one from the same state:
    bit for bit, else each parameter within ``noise_bar``, all
    but ZOO_APART of the elements outside ``zero_grads`` within 1e-5, and
    the buffers (BatchNorm's running statistics) within 1e-5 of max(1,
    |eager|). -> "bit for bit" or the elements apart."""
    pairs = list(zip(eager.named_parameters(), captured.parameters()))
    same = all(torch_equal(a, b) for (_, a), b in pairs) and all(
        torch_equal(a, b) for a, b in zip(eager.buffers(),
                                          captured.buffers()))
    if same:
        return "bit for bit"
    n_apart, n_held, worst = 0, 0, 0.0
    for (n, a), b in pairs:
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        check(diff.max().item() <= noise_bar, f"{tag}: {what}: {n} differs "
              f"by {diff.max().item()} > {noise_bar}")
        if not n.endswith(tuple(zero_grads)):
            n_apart += int((diff > 1e-5).sum().item())
            n_held += diff.numel()
    check(n_apart <= ZOO_APART * n_held, f"{tag}: {what}: {n_apart} of "
          f"{n_held} elements differ by more than 1e-5")
    for a, b in zip(eager.buffers(), captured.buffers()):
        rel = ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
        check(rel <= 1e-5, f"{tag}: {what}: a running statistic differs by "
              f"{rel} of max(1, |eager|)")
    log(f"{tag}: {what}: not bit for bit (cuDNN's weight gradients add with "
        f"atomics in another order each run, and Adam moves an element "
        f"whose gradient is within that of 0 by +-lr): {n_apart} of "
        f"{n_held} elements over 1e-5 apart, the worst {worst:.3e}; the "
        f"running statistics within 1e-5")
    return n_apart


def phase_zoo_train(torch):
    """Phase zoo-train: mobilenet_v2 (scale 1.0, 1000 classes, dropout
    0.2), weights from seed 0, f32 NCHW, batch 256 x 224: Model.fit with
    AdamW(1e-3, weight_decay=1e-4, fused_kernel=True) over 12 steps of
    SyntheticImageNet (1024 images, 3 epochs, 2 workers), each step
    recorded by the Engine as one CUDA graph (its first eager, its second
    recorded, the rest replayed): #10 launched through its wrapper by the
    eager step and the recording alone, once each, no other kernel of the
    port and no plain twin; the graph holds #10 once; the losses fall;
    ms a step and images/s over steps 5-12, peak memory, one step
    profiled. Then the eager and the captured Engine from the same
    weights, batch and generator state (_graph_pair: 5 steps in lockstep,
    each step from the same state, then timed in turns eager, captured,
    captured, eager), and one step on the card against the CPU at batch 8
    x 224 with dropout off (the two devices' generators differ). #10 at
    MobileNetV2's leaf set against its twin, timed beside its bound and
    torch.optim.AdamW(fused=True)."""
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import SyntheticImageNet
    tag, b, epochs, warm = "zoo-train", 256, 3, 4
    out = {}
    torch.cuda.empty_cache()
    ds = SyntheticImageNet(n=4 * b, image_size=224)
    net = _zoo_model(torch, "mobilenet_v2", "cuda", 0)
    opt = _mobilenet_adamw(net)
    model = Model(net)
    model.prepare(opt, nn.CrossEntropyLoss())
    check(model._engine.captures, f"{tag}: the Engine does not capture "
          f"({model._engine.eager_reason})")
    # the profiled step comes ahead of the timed ones: starting the
    # profiler costs the host seconds
    probe = _FitProbe(torch, profile_after=warm - 2)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    with _TwinWatch() as twins, _AdamWWatch() as watch:
        model.fit(ds, batch_size=b, epochs=epochs, shuffle=False,
                  num_workers=2, verbose=0, callbacks=[probe.callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = epochs * len(ds) // b
    check(not twins.calls, f"{tag}: plain twins ran {twins.calls}")
    # the wrappers count the Engine's eager first step and its recording;
    # a replay launches #10 from the graph
    _only(tag, launches, "fused_adamw_multi_update", 2)
    leaves = _check_adamw_route(tag, net, opt, watch, launches, 2)
    nodes = _graph_node_names(torch, _recording(model._engine, "train").graph)
    n_adamw = sum("adamw_kernel" in n for n in nodes)
    check(n_adamw == 1, f"{tag}: the step's graph holds #10 {n_adamw} times")
    losses = probe.losses
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{tag}: losses {losses}")
    first, last = sum(losses[:4]), sum(losses[-4:])
    check(last < first, f"{tag}: the loss did not fall: {losses}")
    out.update(launches=launches, leaves=leaves, graph_nodes=len(nodes),
               losses=losses, peak_gib=peak, fit_wall_s=wall,
               fit_profile=probe.busy(tag),
               recorded_launches={"fused_adamw_multi_update": 1})
    out.update(_step_rates(tag, model, probe, b, warm))
    log(f"{tag}: mobilenet_v2 f32, batch {b} x 224, AdamW fused, Model.fit "
        f"over {steps} captured steps in {wall:.2f} s: "
        f"{out['ms_per_step']:.3f} ms a step, {out['images_per_s']:.1f} "
        f"images/s over steps {warm + 1}-{steps}; #10 once in the step's "
        f"graph of {len(nodes)} nodes over {leaves} leaves, no twin; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak {peak:.2f} GiB")
    # the fit's callbacks and the Model refer to each other: collect the
    # cycle, so that its graph's pool is freed before two Engines run
    del model, net, opt, probe
    gc.collect()
    torch.cuda.empty_cache()

    x, y = (t.cuda() for t in next(iter(DataLoader(ds, batch_size=b))))
    lr = 1e-3

    def compare(tag, what, eager, captured, start, noise_bar=None):
        # each step from the same state: 2 * lr a step, not over steps
        return _apart_compare(tag, what, eager, captured, start,
                              zero_grads=MOBILENET_ZERO_GRADS,
                              noise_bar=2 * lr + 1e-5)
    r = _graph_pair(
        torch, f"{tag} eager vs captured",
        lambda cap: _mobilenet_engine(torch, "cuda", cap), [x], [y],
        ZOO_GROUPS, expect={"fused_adamw_multi_update": 1},
        compare=compare)
    me, ee, mc, ce = r.pop("engines")
    nodes = _graph_node_names(torch, _recording(ce, "train").graph)
    check(sum("adamw_kernel" in n for n in nodes) == 1,
          f"{tag}: the captured Engine's graph holds #10 "
          f"{sum('adamw_kernel' in n for n in nodes)} times")
    out["graph_pair"] = r
    del me, ee, mc, ce, x, y
    torch.cuda.empty_cache()

    out["cpu"] = _zoo_train_cpu(torch)
    gen = torch.Generator(device="cuda").manual_seed(8)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    shapes = _leaf_shapes(torch, lambda: _zoo_model(torch, "mobilenet_v2",
                                                   "cuda", 0))
    out["adamw"] = _adamw_set_case(torch, "mobilenet_v2", shapes, gen,
                                   scratch.zero_, wd=1e-4)
    del scratch
    torch.cuda.empty_cache()
    return out


def _zoo_train_cpu(torch):
    """One AdamW step of mobilenet_v2 on the card and on the CPU from the
    same weights (BatchNorm statistics and affine parameters drawn at
    random) at batch 8 x 224, dropout off (the devices' generators
    differ), as resnet-train-cpu holds ResNet-50: a ReLU6 input within the
    f32 forward's error of a kink (0 or 6) takes the other branch on one
    device, and every gradient upstream of it moves, so the gradients are
    read against a float64 step on the CPU (Adam's m / (1 - beta1) after
    the step, leaf by leaf in relative L2: the card's median and worst
    leaf at most 1.5x as far as the CPU's; the projections' BatchNorm
    biases, zero in exact arithmetic, left out). Then section 2's bars:
    the loss 1e-4 relative, the running statistics 1e-4 of their max-abs,
    the parameters within 1e-5 where both devices' gradients (Adam's m)
    agree in sign and pass 1e-6 (m 1e-7), else within 2 * lr + 1e-5:
    Adam's first step is lr times the sign of g."""
    import numpy as np
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi import Engine
    tag, lr = "zoo-train-cpu", 1e-3
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((8, 3, 224, 224)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, (8,)).astype(np.int64))
    models, opts, loss = {}, {}, {}
    state = None
    for dev, dtype in (("cuda", None), ("cpu", None),
                       ("f64", torch.float64)):
        net = _zoo_model(torch, "mobilenet_v2", "cuda" if dev == "cuda"
                         else "cpu", 5, dtype=dtype)
        for m in net.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0
        if state is None:
            _randomize_bn(torch, net, 35)
            state = {k: v.detach().cpu().clone()
                     for k, v in net.state_dict().items()}
        else:
            net.load_state_dict(state)
        net.train()
        models[dev] = net
        xd, yd = x.to(next(net.parameters()).device), y
        if dev == "f64":
            nn.CrossEntropyLoss()(net(xd.double()), yd).backward()
            continue
        opts[dev] = _mobilenet_adamw(net)
        eng = Engine(net, nn.CrossEntropyLoss(), opts[dev])
        loss[dev] = eng.train_batch([xd], [yd.to(xd.device)])[0].item()
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    check(rel <= 1e-4, f"{tag}: loss cuda {loss['cuda']} vs cpu "
          f"{loss['cpu']} ({rel} relative)")
    g64 = {n: p.grad for n, p in models["f64"].named_parameters()
           if not n.endswith(MOBILENET_ZERO_GRADS)}
    far = {dev: sorted((opts[dev]._state[n]["m"].cpu().double() / 0.1
                        - g).norm().item() / g.norm().item()
                       for n, g in g64.items()) for dev in opts}
    for at in (len(g64) // 2, -1):
        check(far["cuda"][at] <= 1.5 * far["cpu"][at], f"{tag}: the card's "
              f"gradients sit {far['cuda'][at]} from float64, the CPU's "
              f"{far['cpu'][at]}")
    gstate = {k: v.cpu() for k, v in models["cuda"].state_dict().items()}
    stats, n_flip, n_held, worst, worst_flip = 0.0, 0, 0, 0.0, 0.0
    for k, c in models["cpu"].state_dict().items():
        diff = (gstate[k] - c).abs()
        if k.endswith(("_mean", "_variance")):
            e = diff.max().item() / c.abs().max().item()
            check(e <= 1e-4, f"{tag}: {k} differs by {e} of its max-abs")
            stats = max(stats, e)
            continue
        # Adam's first step is lr * g / (|g| + eps): where the devices'
        # gradients agree in sign and pass 1e-6 the parameters agree to
        # 1e-5; elsewhere (a gradient within the devices' f32 error of 0,
        # which the float64 reading above bounds) they lie 2 * lr apart
        gg, gc = (opts[d]._state[k]["m"].cpu() for d in ("cuda", "cpu"))
        flip = ((gg.sign() != gc.sign()) | (gg.abs() < 1e-7)
                | (gc.abs() < 1e-7))
        if (~flip).any():
            worst = max(worst, diff[~flip].max().item())
        if flip.any():
            worst_flip = max(worst_flip, diff[flip].max().item())
        if not k.endswith(MOBILENET_ZERO_GRADS):
            n_flip += int(flip.sum().item())
            n_held += diff.numel()
    check(worst <= 1e-5 and worst_flip <= 2 * lr + 1e-5, f"{tag}: after the "
          f"step parameters differ by {worst} where the devices' gradients "
          f"agree in sign and pass 1e-6, by {worst_flip} elsewhere")
    log(f"{tag}: mobilenet_v2 f32, 8 x 224, AdamW fused, one step cuda vs "
        f"cpu from the same weights: loss cuda {loss['cuda']:.6f} cpu "
        f"{loss['cpu']:.6f} ({rel:.2e} relative); the gradients against a "
        f"float64 step, relative L2 (median, worst leaf): "
        + "; ".join(f"{dev} {v[len(v) // 2]:.2e}, {v[-1]:.2e}"
                    for dev, v in far.items())
        + f"; running statistics {stats:.2e} of their max-abs; parameters "
        f"within {worst:.2e} where the gradients agree in sign and pass "
        f"1e-6, {worst_flip:.2e} at the {n_flip} of {n_held} elements "
        f"(outside the zero-gradient biases) where they do not")
    del models, opts
    return dict(loss_rel=rel, f64=far, stats=stats, param_err=worst,
                sign_differs=n_flip)


def _host_ms(torch, fn, reps=5):
    """Host wall ms of fn() ending in a sync, the median of ``reps`` after
    one warm-up: for calls that read the device back themselves."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _syncs(torch, fn):
    """The synchronizing CUDA calls fn() makes (PyTorch's sync debug mode
    warns at each)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_vision_ops(torch):
    """Phase vision-ops: each op of vision.ops on the card against the CPU
    on the same inputs at the sizes of the detectors that use it: nms over
    2000 boxes of 80 categories with top_k 100 and without (indices
    equal); roi_align and roi_pool over 512 RoIs on an FPN P2 level [2,
    256, 200, 336] at 7 x 7 (scale 1/4); PSRoIPool on [2, 490, 50, 84] at
    7 x 7 (scale 1/16); deform_conv2d v2 (mask) on [2, 256, 100, 168], 3 x
    3, 256 out; box_coder encoding 64 boxes against 2000 priors and
    decoding [8, 2000, 4]; yolo_box on [8, 255, 20, 20] (3 anchors, 80
    classes); distribute_fpn_proposals of 2000 RoIs over levels 2-5
    (levels and masks equal). f32 within 1e-4 of max(1, |cpu|). Each op's
    ms on the card (held by time_ms; nms, which reads back, by the host
    clock over calls ending in a sync) and its synchronizing calls a call
    (PyTorch's sync debug mode)."""
    import numpy as np
    from paddle_tpu_torch.vision import ops
    rng = np.random.default_rng(50)
    out = {}

    def boxes(n, lo, hi, wmin, wmax):
        xy = rng.uniform(lo, hi, (n, 2))
        wh = rng.uniform(wmin, wmax, (n, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    def both(a):
        t = torch.from_numpy(a)
        return t.cuda(), t

    def close(name, got, want):
        got, want = got.float().cpu(), want.float()
        err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        check(math.isfinite(err) and err <= 1e-4,
              f"vision-ops {name}: {err} of max(1, |cpu|) > 1e-4")
        return err

    def report(name, fn, err, held=True):
        syncs = _syncs(torch, fn)
        ms = time_ms(torch, fn) if held else _host_ms(torch, fn)
        out[name] = dict(ms=float(ms), held=held, syncs_per_call=syncs,
                         err=err)
        log(f"vision-ops {name}: {float(ms):.4f} ms on the card "
            f"({'held' if held else 'host clock, ending in a sync'}), "
            f"{syncs} synchronizing calls a call; "
            + (f"{err:.3e} of max(1, |cpu|) from the CPU" if err is not None
               else "equal to the CPU's"))

    # nms: 2000 scored boxes of 80 categories
    bx, sc = both(boxes(2000, 0, 600, 8, 160))
    sg, scpu = both(rng.uniform(0, 1, 2000).astype(np.float32))
    cg, ccpu = both(rng.integers(0, 80, 2000).astype(np.int64))
    for top_k in (100, None):
        name = f"nms top_k={top_k}"
        n0 = ops.nms.host_reads
        got = ops.nms(bx, 0.5, scores=sg, category_idxs=cg,
                      categories=list(range(80)), top_k=top_k)
        reads = ops.nms.host_reads - n0
        want = ops.nms(sc, 0.5, scores=scpu, category_idxs=ccpu,
                       categories=list(range(80)), top_k=top_k)
        check(got.device.type == "cuda" and torch.equal(got.cpu(), want),
              f"vision-ops {name}: indices differ from the CPU's")
        report(name, lambda k=top_k: ops.nms(
            bx, 0.5, scores=sg, category_idxs=cg,
            categories=list(range(80)), top_k=k), None, held=False)
        out[name].update(kept=int((want >= 0).sum()), host_reads=reads)
    # RoI ops on an FPN P2 level
    xg, xc = both(rng.standard_normal((2, 256, 200, 336)).astype(np.float32))
    rg, rc = both(boxes(512, 0, 1200, 16, 300))
    ng, nc = both(np.array([256, 256], np.int64))
    for name, fn in (("roi_align", lambda x, r, n: ops.roi_align(
            x, r, n, 7, spatial_scale=0.25, sampling_ratio=2)),
            ("roi_pool", lambda x, r, n: ops.roi_pool(
                x, r, n, 7, spatial_scale=0.25))):
        err = close(name, fn(xg, rg, ng), fn(xc, rc, nc))
        report(name, lambda fn=fn: fn(xg, rg, ng), err)
    del xg, xc
    pg, pc = both(rng.standard_normal((2, 490, 50, 84)).astype(np.float32))
    ps = ops.PSRoIPool(7, spatial_scale=1 / 16)
    err = close("PSRoIPool", ps(pg, rg, ng), ps(pc, rc, nc))
    report("PSRoIPool", lambda: ps(pg, rg, ng), err)
    del pg, pc
    # deformable convolution v2 at a DCN stage's size
    xg, xc = both(rng.standard_normal((2, 256, 100, 168)).astype(np.float32))
    og, oc = both((rng.standard_normal((2, 18, 100, 168)) * 2).astype(
        np.float32))
    mg, mc = both(rng.uniform(0, 1, (2, 9, 100, 168)).astype(np.float32))
    wg, wc = both((rng.standard_normal((256, 256, 3, 3)) * 0.02).astype(
        np.float32))
    bg, bc = both(rng.standard_normal(256).astype(np.float32))
    err = close("deform_conv2d", ops.deform_conv2d(
        xg, og, wg, bg, padding=1, mask=mg), ops.deform_conv2d(
        xc, oc, wc, bc, padding=1, mask=mc))
    report("deform_conv2d", lambda: ops.deform_conv2d(
        xg, og, wg, bg, padding=1, mask=mg), err)
    del xg, xc, og, oc, mg, mc
    # box_coder against 2000 priors, both ways
    prg, prc = both(boxes(2000, 0, 1, 0.05, 0.4))
    var = [0.1, 0.1, 0.2, 0.2]
    tg, tc = both(boxes(64, 0, 1, 0.05, 0.4))
    err = close("box_coder encode", ops.box_coder(prg, var, tg),
                ops.box_coder(prc, var, tc))
    report("box_coder encode", lambda: ops.box_coder(prg, var, tg), err)
    dg, dc = both((rng.standard_normal((8, 2000, 4)) * 0.3).astype(
        np.float32))
    kw = dict(code_type="decode_center_size")
    err = close("box_coder decode", ops.box_coder(prg, var, dg, **kw),
                ops.box_coder(prc, var, dc, **kw))
    report("box_coder decode", lambda: ops.box_coder(prg, var, dg, **kw),
           err)
    # yolo_box on a YOLOv3 head at 640 / 32
    yg, yc = both((rng.standard_normal((8, 255, 20, 20)) * 2).astype(
        np.float32))
    ig, ic = both(np.full((8, 2), 640, np.int32))
    kw = dict(anchors=[116, 90, 156, 198, 373, 326], class_num=80,
              conf_thresh=0.01, downsample_ratio=32)
    (b1, s1), (b2, s2) = ops.yolo_box(yg, ig, **kw), ops.yolo_box(yc, ic,
                                                                  **kw)
    err = max(close("yolo_box boxes", b1, b2), close("yolo_box scores", s1,
                                                     s2))
    report("yolo_box", lambda: ops.yolo_box(yg, ig, **kw), err)
    # FPN level assignment
    fg, fc = both(boxes(2000, 0, 800, 4, 700))
    (lg, mgk), (lc, mck) = (ops.distribute_fpn_proposals(
        r, 2, 5, 4, 224) for r in (fg, fc))
    check(torch.equal(lg.cpu(), lc) and torch.equal(mgk.cpu(), mck),
          "vision-ops distribute_fpn_proposals: levels differ from the "
          "CPU's")
    report("distribute_fpn_proposals", lambda: ops.distribute_fpn_proposals(
        fg, 2, 5, 4, 224), None)
    out["distribute_fpn_proposals"]["levels"] = {
        int(k): int(v) for k, v in zip(*np.unique(lc.numpy(),
                                                  return_counts=True))}
    torch.cuda.empty_cache()
    return out


# -- the training paths' steps, one package tree against another -------------

def _lm_steps(torch, tag, eng, inputs, labels, warm, steps):
    """``warm`` steps, ``steps`` timed ones ending in one sync, then one
    profiled step: ms a step, the host's kernel launches and the busy
    share of the profiled step."""
    for _ in range(warm):
        eng.train_batch(inputs, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = eng.train_batch(inputs, labels)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    check(math.isfinite(loss.item()), f"{tag}: loss {loss.item()}")
    prof = profile_grouped(torch, tag, "one training step",
                           lambda: eng.train_batch(inputs, labels),
                           LM_TRAIN_GROUPS)
    log(f"{tag}: {steps} steps, {ms:.3f} ms a step")
    return dict(ms_per_step=ms, launch_calls=prof["launch_calls"],
                busy_share=prof["busy_share"])


def steps_of(torch):
    """The training paths' step numbers with whatever paddle_tpu_torch is
    first on sys.path (its kernels built from its own sources): gpt3-345M
    (batch 8 x 1024) and ERNIE-3.0-base (32 x 512), 3 warm-up and 10
    timed steps, GPT-1.3B (4 x 1024) 2 + 5, each with one profiled step,
    eager and, where the tree's Engine records a step as a CUDA graph
    (``capture``), captured ("... captured"); DETR-R50 through Model.fit
    as phase detr-train runs it (16 steps, steps 5-16 timed, eager: its
    loss reads the host) and one Model.train_batch profiled; the LeNet
    quickstart's 6 epochs, eager and captured. Every path with
    AdamW(fused_kernel=True), bf16 AMP for the language models, as the
    smoke's phases run them."""
    import inspect

    import numpy as np
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nlp.ernie import _resolve_config as ernie_config
    from paddle_tpu_torch.nlp.gpt import _resolve_config
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import DETR, DETRLoss, LeNet
    log(f"steps-of: paddle_tpu_torch from {os.path.dirname(_build.CSRC_DIR)}")
    _build.build_all()
    modes = ((None, ""),)
    if "capture" in inspect.signature(Engine).parameters:
        modes = ((False, ""), (True, " captured"))
    out = {}
    for capture, suffix in modes:
        for name, b, warm, steps in (("gpt3-345M", 8, 3, 10),
                                     ("gpt3-1.3B", 4, 2, 5)):
            cfg = _resolve_config(name, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
            model, eng = _train_engine(torch, cfg, "cuda",
                                       amp=torch.bfloat16, capture=capture)
            ids, labels = _batch(cfg, b, 1024, "cuda")
            out[name + suffix] = _lm_steps(torch, name + suffix, eng, [ids],
                                           [labels], warm, steps)
            del model, eng
            torch.cuda.empty_cache()
        cfg = ernie_config("ernie-3.0-base-zh", hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0, fused_ln=True)
        model, eng = _ernie_engine(torch, cfg, "cuda", amp=torch.bfloat16,
                                   capture=capture)
        inputs, labels = _ernie_batch(cfg.vocab_size, 32, 512, "cuda")
        out["ernie-3.0-base" + suffix] = _lm_steps(
            torch, "ernie-3.0-base" + suffix, eng, inputs, labels, 3, 10)
        del model, eng
        torch.cuda.empty_cache()
    tag, b, warm = "detr-r50", 4, 4
    ds = _detection_set(4 * b, *DETR_HW, seed=40)
    net = DETR(device="cuda", generator=seed(0))
    model = Model(net, inputs=["images"])
    model.prepare(_detr_adamw(net), DETRLoss(num_classes=80))
    _, probe, _, _ = _fit_detection(torch, tag, model, ds, b, 4,
                                    profile_after=warm - 2)
    r = _step_rates(tag, model, probe, b, warm)
    x, gb, gc, gm = ds.batch(torch, slice(0, b), "cuda")
    prof = profile_grouped(torch, tag, "one Model.train_batch",
                           lambda: model.train_batch([x], [gb, gc, gm]),
                           DETECT_TRAIN_GROUPS)
    out[tag] = dict(ms_per_step=r["ms_per_step"],
                    launch_calls=prof["launch_calls"],
                    busy_share=prof["busy_share"])
    del model, net, x
    torch.cuda.empty_cache()
    for capture, suffix in modes:
        net = LeNet(device="cuda", generator=seed(0, device="cuda"))
        model = Model(net)
        model.prepare(Adam(1e-3, parameters=net.parameters(),
                           fused_kernel=True),
                      nn.CrossEntropyLoss(), Accuracy(),
                      **({} if capture is None else dict(capture=capture)))
        np.random.seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(MNIST(mode="train"), epochs=6, batch_size=256, verbose=0)
        torch.cuda.synchronize()
        out["lenet" + suffix] = dict(epoch_s=(time.perf_counter() - t0) / 6)
        log(f"lenet{suffix}: 6 epochs, "
            f"{out['lenet' + suffix]['epoch_s']:.3f} s an epoch")
    return out


def compare_steps(torch, trees):
    """steps_of each tree in turn, in a process of its own, in the order
    given (parent, change, change, parent puts drift on both sides), then
    every path's numbers side by side."""
    runs = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--steps-of", tree],
            capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        check(proc.returncode == 0, f"--steps-of {tree} failed:\n"
              f"{proc.stderr[-3000:]}")
        runs.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
    paths = [p for _, r in runs for p in r]
    for path in dict.fromkeys(paths):
        keys = dict.fromkeys(k for _, r in runs for k in r.get(path, {}))
        for key in keys:
            vals = ", ".join(f"{tree} {r[path][key]}" for tree, r in runs
                             if path in r)
            log(f"compare-steps: {path} {key}: {vals}")


# (leaves a launch takes, values a chunk) that --adamw-geometry builds #10
# at; the first is the kernel's own
ADAMW_GEOMETRIES = ((512, 4096), (16, 4096), (512, 16384), (16, 16384),
                    (512, 2048), (512, 1024))


def adamw_geometry(torch):
    """#10's launch geometry measured: csrc/fused_adamw.cu built once a
    (leaves a launch, values a chunk) pair of ADAMW_GEOMETRIES, all nvcc
    processes started together. The parameter struct a launch carries
    grows with the leaves it takes (26.7 KB at 512, 0.9 KB at 16); a set's
    blocks, one a chunk, shrink as the chunk grows. Each build updates, in
    the plan ``multi_plan`` makes for its geometry, LeNet's 10 leaves, a
    256 x 2048 (DETR's) and a 1024 x 4096 leaf alone, and DETR-R50's 422
    and GPT-345M's 388 leaf sets: once from the same start, held to the
    twin at ADAMW_TOL of max(1, |twin|), then timed (held, L2 flushed)
    beside the bound (28 bytes a value)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.kernels import fused_adamw as ka
    from paddle_tpu_torch.vision.models import DETR, LeNet
    import numpy as np
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "fused_adamw.cu")
    procs = {}
    for cap, chunk in ADAMW_GEOMETRIES:
        out = os.path.join(_build.BUILD_DIR,
                           f"libfused_adamw-geometry-{cap}-{chunk}.so")
        procs[(cap, chunk)] = out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             f"-DFUSED_ADAMW_MAX_LEAVES={cap}", f"-DFUSED_ADAMW_CHUNK={chunk}",
             "-o", out, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for key, (out, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"adamw-geometry: nvcc {key}:\n{text}")
        lib = ctypes.CDLL(out)
        got = (lib.fused_adamw_max_leaves(), lib.fused_adamw_chunk())
        check(got == key, f"adamw-geometry: built {got}, asked {key}")
        fn = lib.fused_adamw_multi_update
        fn.restype, fn.argtypes = ctypes.c_int, ka._ARGTYPES
        fns[key] = fn
    gen = torch.Generator(device="cuda").manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, device="cuda").zero_
    step = (1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3)
    step_t = ka.step_scalars(*step, device="cuda")
    hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=True)
    sets = {
        "lenet": _leaf_shapes(torch, lambda: LeNet(
            device="cuda", generator=seed(0, device="cuda"))),
        "one 256x2048": [("w", (256, 2048))],
        "one 1024x4096": [("w", (1024, 4096))],
        "detr-r50": _leaf_shapes(torch, lambda: DETR(
            device="cuda", generator=seed(0, device="cuda"))),
        "gpt3-345M": _leaf_shapes(torch, lambda: GPTForCausalLM(
            _resolve_config("gpt3-345M"), device="cuda",
            generator=seed(0, device="cuda")))}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, shapes in sets.items():
        sizes = [math.prod(s) for _, s in shapes]
        total = sum(sizes)

        def mk(scale=1.0, absolute=False):
            xs = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
            return [(x.abs() if absolute else x).mul_(scale) for x in xs]
        start = (mk(), mk(0.1), mk(0.01, absolute=True))
        g = mk()
        wds = [0.01] * len(sizes)
        twin = [[x.clone() for x in xs] for xs in start]
        ka.adamw_multi_update_plain(*twin, g, *step, weight_decays=wds, **hp)
        kern = [[x.clone() for x in xs] for xs in start]
        bound_ms, _ = bound(28 * total, 15 * total)
        row = dict(leaves=len(sizes), values=total, bound_ms=bound_ms)
        for (cap, chunk), fn in fns.items():
            for xs, ys in zip(kern, start):
                for x, y in zip(xs, ys):
                    x.copy_(y)
            launches = []
            for lo, hi, first in ka.multi_plan(sizes, cap, chunk):
                ptrs = np.asarray([[t.data_ptr() for t in (p, m, v, gg)]
                                   for p, m, v, gg in zip(
                                       *(xs[lo:hi] for xs in kern),
                                       g[lo:hi])], np.int64)
                launches.append((hi - lo, ptrs, np.asarray(
                    sizes[lo:hi], np.int64), np.asarray(
                    wds[lo:hi], np.float32), first))

            def run():
                for k, ptrs, n, wd, first in launches:
                    err = fn(k, ptrs.ctypes.data, n.ctypes.data,
                             wd.ctypes.data, first.ctypes.data,
                             step_t.data_ptr(),
                             0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 1,
                             None, None, stream)
                    check(err == 0, f"adamw-geometry: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            rel = max(_err(a, b)[1] for xs, ys in zip(kern, twin)
                      for a, b in zip(xs, ys))
            check(rel <= ADAMW_TOL, f"adamw-geometry {name} {cap}x{chunk}: "
                  f"{rel} of max(1, |twin|) > {ADAMW_TOL}")
            ms = time_ms(torch, run, flush=flush)
            blocks = sum(int(first[-1]) for *_, first in launches)
            row[f"{cap}x{chunk}"] = dict(ms=ms, unheld=unheld(ms),
                                         launches=len(launches),
                                         blocks=blocks, max_rel_err=rel)
            log(f"adamw-geometry: {name} ({len(sizes)} leaves, {total} "
                f"values), {cap} leaves a launch x {chunk} values a chunk: "
                f"{len(launches)} launch(es), {blocks} blocks, held ms "
                f"{ms:.4f} (unheld {unheld(ms):.4f}), bound {bound_ms:.4f} "
                f"({bound_ms / ms:.3f} of it), max_rel_err {rel:.3e}")
        out[name] = row
        del start, g, twin, kern
        torch.cuda.empty_cache()
    floor = launch_floor(torch)
    log(f"adamw-geometry: the launch floor held {floor:.4f} ms")
    out["launch_floor_ms"] = floor
    print(json.dumps(out), flush=True)


# -- float16 AMP training under TrainGuard (phase fp16-guard) -----------------

# the main run: gpt3-345M through Model.fit, 14 steps at 8 x 1024, a
# nan_grads storm over steps 6-8, the guard snapshotting every 4 good steps
# into a ring of one and rolling back after 3 bad ones
FP16_STEPS = 14
FP16_STORM = (6, 3)
FP16_GUARD = dict(snapshot_every=4, ring_size=1, rollback_after=3)
FP16_SCALER = dict(init_loss_scaling=65536.0, incr_every_n_steps=4)
# resnet50's guard and storm (phase fp16-resnet): at its seeded init the
# stem's unscaled weight gradient reaches 4.3-4.5 (bf16 and f32 steps on
# the card), past 65504 / 16384, so float16 steps at scales 65536, 32768
# and 16384 all overflow; with rollback_after 3 the third skip rolls back
# to the first snapshot, taken at 65536, and no step is ever applied. Four
# lets the scaler reach 8192; the storm is four steps, so it rolls back
RESNET_F16_GUARD = dict(FP16_GUARD, rollback_after=4)
RESNET_F16_STORM = (9, 4)
# the bars of fp16-resnet's cut check for the leaves behind a ReLU or the
# max-pool, whose float16 gradients differ where a rounding flips a ReLU or
# a pool's winner (see _fp16_resnet_cpu)
RESNET_CUT_LEAF_BAR = 0.3
RESNET_CUT_RATIO_BAR = 0.1
# the f16 flash kernels' graph-node names carry their template argument
F16_MANGLED = "6__half"


def _f16_overflow_case(torch, gen):
    """#3/#4 in float16 with dO scaled up (|dO| to 6e4) so that ds passes
    float16's 65504: the kernels' dq, dk and dv hold +inf, -inf and NaN at
    exactly the twins' places (the twins round with ``.to(float16)``, as the
    reference's astype: no saturation). Their finite values are held in
    relative L2 at the float16 bar, not elementwise: the kernel's exp
    (ex2.approx) and the twin's can round a p, and so a ds, to neighbouring
    float16 values. For dq and dk a float16 ulp of ds near 6e4 is 32; dv =
    P^T.dO uses no ds, but a float16 ulp of p (up to 2^-11) times |dO| up
    to 6e4 is ~30. Summed with cancellation over the keys (dq) or the
    queries (dk, dv), such terms move single elements by units against
    values near 0: up to 0.66 (dq) and 1.56 (dv) of max(1, |twin|)
    measured on the H100.
    -> {name: non-finite count and the finite part's errors}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    bh, s, d = 32, 256, 64
    mk = lambda: torch.randn(bh, s, d, generator=gen,  # noqa: E731
                             device="cuda")
    q, k, v = (mk().half() for _ in range(3))
    do = (mk().clamp_(-4.0, 4.0) * 1.5e4).half()
    rest = (None, None, True, None, 0.0)
    o, lse = kfa.flash_attention_fwd(q, k, v, *rest)
    dq, delta = kfa.flash_attention_bwd_dq(q, k, v, o, do, lse, *rest)
    dk, dv = kfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *rest)
    pdq, _ = kfa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse, *rest)
    pdk, pdv = kfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 *rest)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(pdq).all()), "fp16-guard: the overflow "
          "case's twin dq is finite: nothing to hold")
    out = {}
    for name, a, p in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        for what, f in (("+inf", torch.isposinf), ("-inf", torch.isneginf),
                        ("NaN", torch.isnan)):
            n_diff = int((f(a) != f(p)).sum())
            check(n_diff == 0, f"fp16-guard: overflow case: {name}'s {what} "
                  f"differs from the twin's at {n_diff} places")
        ok = torch.isfinite(p)
        fa, fp = a[ok].float(), p[ok].float()
        err, rel = _err(fa, fp)
        l2 = ((fa - fp).norm() / fp.norm().clamp_min(1e-30)).item()
        check(l2 <= TOL["float16"], f"fp16-guard: overflow case: {name}'s "
              f"finite values {l2} relative L2 from the twin's")
        out[name] = dict(nonfinite=int((~ok).sum()), max_abs_err=err,
                         rel=rel, l2=l2)
    log(f"fp16-guard: #3/#4 float16 overflow case ({bh} x {s} x {d}, |dO| "
        f"to 6e4): non-finite values (kernel == twin, place by place, "
        f"+inf/-inf/NaN) "
        + ", ".join(f"{n} {r['nonfinite']} (finite part {r['l2']:.2e} "
                    f"relative L2, {r['rel']:.2e} of max(1, |twin|) at "
                    f"worst)" for n, r in out.items()))
    return out


def _f16_refusals(torch, gen):
    """The float16 call still to port raises on the card naming ROADMAP.md
    queue 2: #1 at head_dim 32 (ValueError). No kernel launches and no
    plain twin runs in its place. (#2 and #5 take float16: phase
    fp16-decode.) -> {wrapper: ["raises <error>[ at ...]"]}."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    q32 = torch.zeros(4, 64, 32, dtype=torch.float16, device="cuda")
    calls = (
        ("#1", "flash_attention_fwd", " at head_dim 32", ValueError,
         lambda: kfa.flash_attention_fwd(q32, q32, q32)),
    )
    refused = {}
    before = {fn.__name__: fn.launches for fn in WRAPPERS}
    with _TwinWatch() as tw:
        for num, name, where, err, call in calls:
            try:
                call()
            except err as e:
                check("ROADMAP.md queue 2" in str(e), f"fp16-guard: {num} "
                      f"{name}{where} refused float16 without naming queue "
                      f"2: {e}")
                refused.setdefault(name, []).append(
                    f"raises {type(e).__name__}{where}")
            else:
                check(False, f"fp16-guard: {num} {name}{where} took float16 "
                      "on the card")
    torch.cuda.synchronize()
    after = {fn.__name__: fn.launches for fn in WRAPPERS}
    check(after == before and not tw.calls, f"fp16-guard: a refused float16 "
          f"call launched {after} (before {before}) or ran a twin "
          f"{tw.calls}")
    log(f"fp16-guard: float16 refused on the card by {len(calls)} call "
        "(#1 at head_dim 32: ValueError), naming ROADMAP.md queue 2; no "
        "launch, no twin ran")
    return refused


def _adamw_guarded_case(torch, shapes, gen, flush):
    """#10 over GPT-345M's leaf set as the guarded step launches it: the
    GradScaler's 1/scale as the gradient scale and the skip flag. Flag
    clear: held to the twin at ADAMW_TOL; flag set: p, m and v unchanged
    bit for bit (kernel and twin). Held ms with the flag clear and set, the
    twin (unheld) and ``torch._fused_adamw_`` with ``grad_scale`` and
    ``found_inf`` (the same function in one PyTorch call), beside the
    bound (28 bytes a value)."""
    from paddle_tpu_torch.ops.kernels import fused_adamw as ka
    sizes = [math.prod(s) for _, s in shapes]
    total = sum(sizes)

    def mk(scale=1.0, absolute=False):
        xs = [torch.randn(s, generator=gen, device="cuda") for _, s in shapes]
        return [(x.abs() if absolute else x).mul_(scale) for x in xs]
    start = (mk(), mk(0.1), mk(0.01, absolute=True))
    g = mk(65536.0)
    wds = [0.0 if _no_decay(n) else 0.01 for n, _ in shapes]
    hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=True,
              weight_decays=wds)
    step_t = ka.step_scalars(1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3,
                             device="cuda")
    inv = torch.tensor(1.0 / 65536.0, device="cuda")
    clear = torch.zeros((), dtype=torch.bool, device="cuda")
    flagged = torch.ones((), dtype=torch.bool, device="cuda")
    clones = lambda: [[x.clone() for x in xs]  # noqa: E731
                      for xs in start]
    kern, twin = clones(), clones()
    table = ka.fused_adamw_multi_update(*kern, g, step_t, scale=inv,
                                        skip=clear, **hp)
    ka.adamw_multi_update_plain(*twin, g, step_t, scale=inv, skip=clear,
                                **hp)
    torch.cuda.synchronize()
    errs = [_err(a, b) for xs, ys in zip(kern, twin) for a, b in zip(xs, ys)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    check(rel <= ADAMW_TOL, f"fp16-guard: #10 guarded (flag clear) {rel} of "
          f"max(1, |twin|) > {ADAMW_TOL}")
    skipped, skipped_twin = clones(), clones()
    ka.fused_adamw_multi_update(*skipped, g, step_t, scale=inv,
                                skip=flagged, **hp)
    ka.adamw_multi_update_plain(*skipped_twin, g, step_t, scale=inv,
                                skip=flagged, **hp)
    torch.cuda.synchronize()
    for got in (skipped, skipped_twin):
        check(all(torch.equal(a, b) for xs, ys in zip(got, start)
                  for a, b in zip(xs, ys)), "fp16-guard: #10 with the skip "
              "flag set wrote a leaf")
    del twin, skipped, skipped_twin
    kp, km, kv = kern
    run = lambda flag: (lambda: ka.fused_adamw_multi_update(  # noqa: E731
        kp, km, kv, g, step_t, scale=inv, table=table, skip=flag, **hp))
    row = dict(leaves=len(shapes), values=total, launches_per_step=1,
               max_abs_err=err, max_rel_err=rel)
    row["ms"] = time_ms(torch, run(clear), flush=flush)
    row["skipped_ms"] = time_ms(torch, run(flagged), flush=flush)
    row["plain_ms"] = time_ms(torch, lambda: ka.adamw_multi_update_plain(
        kp, km, kv, g, step_t, scale=inv, skip=clear, **hp), flush=flush,
        held=False)
    row["library_ms"] = None
    try:
        steps = [torch.full((), 3.0, device="cuda") for _ in kp]
        scale_t = torch.tensor(65536.0, device="cuda")
        found = torch.zeros((), device="cuda")

        def lib():
            torch._fused_adamw_(kp, g, km, kv, [], steps, lr=1e-4,
                                beta1=0.9, beta2=0.999, weight_decay=0.01,
                                eps=1e-8, amsgrad=False, maximize=False,
                                grad_scale=scale_t, found_inf=found)
        row["library_ms"] = time_ms(torch, lib, flush=flush)
    except (TypeError, RuntimeError) as e:
        log(f"fp16-guard: torch._fused_adamw_ with grad_scale/found_inf not "
            f"timed on this torch: {e}")
    row["bound_ms"], row["bound_by"] = bound(28 * total, 15 * total)
    lib_ms = row["library_ms"]
    log(f"fp16-guard: #10 guarded over {len(shapes)} leaves ({total} "
        f"values, 1/scale as the gradient scale): held ms flag clear "
        f"{row['ms']:.4f} (unheld {unheld(row['ms']):.4f}), flag set "
        f"{row['skipped_ms']:.4f}; bound {row['bound_ms']:.4f} "
        f"({row['bound_ms'] / row['ms']:.3f} of it); the twin (unheld) "
        f"{row['plain_ms']:.4f}; torch._fused_adamw_(grad_scale, found_inf) "
        + ("not timed" if lib_ms is None else
           f"{lib_ms:.4f} (unheld {unheld(lib_ms):.4f})")
        + f"; max_abs_err {err:.3e} ({rel:.3e} of max(1, |twin|)); the "
        "flag set leaves every leaf bit for bit (kernel and twin)")
    del kern, g, start
    torch.cuda.empty_cache()
    return row


def _repeated_set(n, *columns):
    """A Dataset of ``n`` samples, sample i the (i mod b)-th row of each of
    ``columns`` (b rows each): every batch of b in order is the same
    batch, so that a few steps' losses fall."""
    from paddle_tpu_torch.io import Dataset
    b = len(columns[0])

    class _Set(Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return tuple(c[i % b] for c in columns)
    return _Set()


def _lm_dataset(cfg, n, b, s, seed):
    """_repeated_set of ``n`` (ids, labels) int64 samples of ``s`` tokens,
    ``b`` of them drawn."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    return _repeated_set(n, ids, rng.integers(0, cfg.vocab_size, (b, s)))


def _fp16_gpt(torch, device, weight_seed=0, **ovr):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    cfg = _resolve_config("gpt3-345M", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, **ovr)
    model = GPTForCausalLM(cfg, device=device,
                           generator=seed(weight_seed, device=device))
    return model.train(), cfg


def _guard_replay(outcomes, init_scale, incr_every, snapshot_every,
                  rollback_after):
    """GradScaler's rules and TrainGuard's ring on the host over the
    steps' read flags (ok = an outcome of "ok"): [(outcome, scale, good,
    bad)] a step, the scaler's state restored from the snapshot on a
    rollback, as the reference restores it."""
    scale, good, bad = float(init_scale), 0, 0
    snap = (scale, good, bad)  # before the first step
    since = consecutive = 0
    out = []
    for seen in outcomes:
        ok = seen == "ok"
        if ok:
            good, bad = good + 1, 0
            if good >= incr_every:
                scale, good = scale * 2.0, 0
        else:
            good, bad = 0, bad + 1
            if bad >= 1:
                scale, bad = max(scale * 0.5, 1.0), 0
        if ok:
            consecutive, since = 0, since + 1
            if since >= snapshot_every:
                snap, since = (scale, good, bad), 0
            outcome = "ok"
        else:
            consecutive += 1
            outcome = "skipped"
            if consecutive >= rollback_after:
                (scale, good, bad), consecutive = snap, 0
                outcome = "rolled_back"
        out.append((outcome, scale, good, bad))
    return out


class _GuardProbe:
    """A fit callback reading, after each step (which has already read its
    flag back), the guard's outcome, the scaler's state, the loss, copies
    of a few leaves and, on a rollback, every live tensor against the
    guard's snapshot; the wall clock at each batch end."""

    def __init__(self, torch, eng, watch):
        from paddle_tpu_torch.hapi.callbacks import Callback
        probe = self
        self.torch, self.eng, self.watch = torch, eng, watch
        self.start = [p.detach().clone() for p in watch]
        self.rows, self.ends, self.ptrs = [], [], None
        self.graph_id = None

        class _CB(Callback):
            def on_train_batch_end(self, step, logs=None):
                probe.batch_end(logs)
        self.callback = _CB()

    def batch_end(self, logs):
        torch, eng = self.torch, self.eng
        self.ends.append(time.perf_counter())
        g = eng.guard
        st = eng._scaler_state
        row = dict(step=eng._step, outcome=g.last_outcome,
                   loss=logs["loss"][0], scale=st["scale"].item(),
                   good=int(st["good"].item()), bad=int(st["bad"].item()),
                   opt_step=eng._opt_step,
                   leaves=[p.detach().clone() for p in self.watch])
        live = eng._guard_tensors()
        ptrs = {k: t.data_ptr() for k, t in live.items()}
        if self.ptrs is None:
            self.ptrs = ptrs
        row["same_ptrs"] = ptrs == self.ptrs
        if g.last_outcome == "rolled_back":
            host = g.ring[-1]["tensors"]
            row["equals_snapshot"] = all(
                torch.equal(t.cpu(), host[k]) for k, t in live.items())
        rec = [r for k, r in eng._recorded.items() if k[0][0] == "guarded"]
        row["recordings"] = len(rec)
        if rec and rec[0].graph is not None:
            self.graph_id = self.graph_id or id(rec[0].graph)
            row["same_graph"] = id(rec[0].graph) == self.graph_id
        self.rows.append(row)


def _timed_guard(torch, guard):
    """The guard's snapshot and rollback timed (synchronized) where the
    Engine calls them: {"snapshot"|"rollback": [(ms, engine step)]}."""
    times = {"snapshot": [], "rollback": []}
    for name in times:
        orig = getattr(guard, name)

        def timed(engine, _orig=orig, _name=name):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _orig(engine)
            torch.cuda.synchronize()
            times[_name].append(((time.perf_counter() - t) * 1e3,
                                 engine._step))
            return out
        setattr(guard, name, timed)
    return times


def _check_guarded(tag, probe, guard, times, guard_kw=None, storm=None,
                   overflow_after_rollback=False):
    """A guarded run of FP16_STEPS steps with nan_grads over ``storm``
    (FP16_STORM: first step, count) under ``guard_kw`` (FP16_GUARD) and
    FP16_SCALER, read by a _GuardProbe: every storm step skipped, each
    step's (outcome, scale, good, bad) equal to GradScaler's rules and
    the guard's ring replayed on the host over the read flags, one
    rollback, to the snapshot before it bit for bit in the same tensors,
    a skipped step leaving the watched tensors unchanged, the step right
    after the rollback good and moving them (with
    ``overflow_after_rollback``, where natural overflows may follow the
    restored scale: the first good step after it), one graph recorded,
    the good steps' losses finite and falling.
    -> {natural, r_step, snap_step, outcomes}."""
    steps = FP16_STEPS
    guard_kw = guard_kw or FP16_GUARD
    storm_at, storm_n = storm or FP16_STORM
    rows = probe.rows
    check(len(rows) == steps, f"{tag}: {len(rows)} steps ran, want {steps}")
    outcomes = [r["outcome"] for r in rows]
    for r in rows:
        log(f"{tag}: step {r['step']}: {r['outcome']}, loss "
            f"{r['loss']:.4f}, scale {r['scale']:g} (good {r['good']}, bad "
            f"{r['bad']}), opt_step {r['opt_step']}")
    storm_steps = set(range(storm_at, storm_at + storm_n))
    natural = [r for r in rows if r["outcome"] != "ok"
               and r["step"] not in storm_steps]
    init = FP16_SCALER["init_loss_scaling"]
    for r in natural:
        log(f"{tag}: step {r['step']} overflowed naturally (the flag was "
            f"set with no fault injected) at loss scale "
            f"{rows[r['step'] - 2]['scale'] if r['step'] > 1 else init:g}")
    check(all(r["outcome"] != "ok" for r in rows
              if r["step"] in storm_steps),
          f"{tag}: a storm step was applied: {outcomes}")
    replay = _guard_replay(outcomes, init, FP16_SCALER["incr_every_n_steps"],
                           guard_kw["snapshot_every"],
                           guard_kw["rollback_after"])
    got = [(r["outcome"], r["scale"], r["good"], r["bad"]) for r in rows]
    check(got == replay, f"{tag}: (outcome, scale, good, bad) a step {got} "
          f"against GradScaler's rules replayed on the host over the read "
          f"flags {replay}")
    rolled = [r["step"] for r in rows if r["outcome"] == "rolled_back"]
    check(guard.rollbacks == 1 and len(rolled) == 1,
          f"{tag}: {guard.rollbacks} rollbacks at steps {rolled}, want 1")
    check(guard.skipped_steps == len(storm_steps) + len(natural),
          f"{tag}: skipped_steps {guard.skipped_steps}, want "
          f"{len(storm_steps)} + {len(natural)} natural")
    r_step = rolled[0]
    snaps = [st for _, st in times["snapshot"]]
    snap_step = max(st for st in snaps if st < r_step)
    by_step = {r["step"]: r for r in rows}
    by_step[0] = {"leaves": probe.start}  # before the first step
    leaves_eq = lambda a, b: all(  # noqa: E731
        torch_equal(x, y) for x, y in zip(a["leaves"], b["leaves"]))
    for r in rows:
        if r["outcome"] == "skipped":
            check(leaves_eq(r, by_step[r["step"] - 1]),
                  f"{tag}: skipped step {r['step']} changed the watched "
                  "tensors")
    rb = by_step[r_step]
    check(rb.get("equals_snapshot") is True and leaves_eq(
        rb, by_step[snap_step]), f"{tag}: after the rollback at step "
        f"{r_step} the state is not step {snap_step}'s snapshot bit for bit")
    if overflow_after_rollback:
        after = next((r for r in rows if r["step"] > r_step
                      and r["outcome"] == "ok"), None)
    else:
        after = by_step.get(r_step + 1)
    check(after is not None and after["outcome"] == "ok"
          and not leaves_eq(after, rb),
          f"{tag}: the good step after the rollback at step {r_step} "
          + ("" if overflow_after_rollback else f"(step {r_step + 1}) ")
          + "did not update the restored state")
    check(all(r["same_ptrs"] for r in rows), f"{tag}: a parameter's, a "
          "buffer's, a slot's or the scaler's data_ptr changed over the run")
    check(all(r.get("same_graph", True) for r in rows)
          and rows[-1]["recordings"] == 1 and probe.graph_id is not None,
          f"{tag}: not exactly one graph recorded over the run (a rollback "
          "must not record again)")
    good = [r["loss"] for r in rows if r["outcome"] == "ok"]
    check(all(math.isfinite(x) for x in good) and good[-1] < good[0],
          f"{tag}: the good steps' losses {good}")
    return dict(natural=natural, r_step=r_step, snap_step=snap_step,
                outcomes=outcomes)


def _fp16_main_run(torch, gen):
    """gpt3-345M through Model.fit under the guard; see FP16_*."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import TrainGuard, faults
    b, s = 8, 1024
    t0 = time.perf_counter()
    model, cfg = _fp16_gpt(torch, "cuda")
    guard = TrainGuard(**FP16_GUARD, scaler=GradScaler(**FP16_SCALER))
    m = Model(model)
    m.prepare(AdamW(1e-4, weight_decay=0.01, fused_kernel=True,
                    parameters=model.named_parameters()),
              GPTPretrainingCriterion(),
              amp_configs={"level": "O1", "dtype": "float16"}, guard=guard)
    eng = m._engine
    ds = _lm_dataset(cfg, b * FP16_STEPS, b, s, seed=1)
    torch.cuda.synchronize()
    log(f"fp16-guard: gpt3-345M built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters, "
        f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads); Model.fit at {b} x {s}, "
        f"float16 O1, AdamW(1e-4, weight_decay=0.01, fused_kernel=True), "
        f"TrainGuard({FP16_GUARD}, GradScaler({FP16_SCALER})), nan_grads at "
        f"steps {FP16_STORM[0]}-{sum(FP16_STORM) - 1}")
    named = list(model.named_parameters())
    watch = [named[i][1] for i in (0, len(named) // 2, len(named) - 1)]
    probe = _GuardProbe(torch, eng, watch)
    times = _timed_guard(torch, guard)
    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    with faults.scenario(("nan_grads", {"step": FP16_STORM[0],
                                        "count": FP16_STORM[1]})):
        m.fit(ds, batch_size=b, epochs=1, shuffle=False, verbose=0,
              callbacks=[probe.callback])
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in WRAPPERS}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    g = _check_guarded("fp16-guard", probe, guard, times)
    rows, natural = probe.rows, g["natural"]
    r_step, snap_step, outcomes = g["r_step"], g["snap_step"], g["outcomes"]
    # #1/#3/#4 in float16 a layer and #10 once in the recorded step's graph
    rec = next((r for k, r in eng._recorded.items()
                if k[0][0] == "guarded"), None)
    check(rec is not None and rec.graph is not None,
          "fp16-guard: the Engine holds no recorded guarded step")
    nodes = _graph_node_names(torch, None if rec is None else rec.graph)
    recorded = {w: sum(frag in n and F16_MANGLED in n for n in nodes)
                for w, frag in GPT_GRAPH_KERNELS}
    recorded["fused_adamw_multi_update"] = sum("adamw_kernel" in n
                                               for n in nodes)
    layers = cfg.num_hidden_layers
    want = {w: layers for w, _ in GPT_GRAPH_KERNELS}
    want["fused_adamw_multi_update"] = 1
    check(recorded == want, f"fp16-guard: the recorded step holds "
          f"{recorded} (float16 flash kernels), want {want}")
    # the wrappers ran at the eager first step and at the recording
    want_calls = {w: 2 * layers for w, _ in GPT_GRAPH_KERNELS}
    want_calls["fused_adamw_multi_update"] = 2
    check({k: launches[k] for k in want_calls} == want_calls,
          f"fp16-guard: wrapper launches {launches}, want {want_calls} (the "
          "eager first step and the recording)")
    # ms a step without the probe's reads: 8 more guarded steps through
    # Model.train_batch on one prefetched batch (captured replays, each
    # ended by the flag's and the loss's reads; the guard snapshots at
    # every 4th good step, 2 of the 8)
    import statistics
    skipped = guard.skipped_steps
    batch = next(iter(m._feed(m._loaders["train"])))
    step_ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.train_batch(*batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    ms_step = statistics.median(step_ms)
    mean_ms = statistics.mean(step_ms)
    tok_s = b * s / (ms_step / 1e3)
    snap_ms = [t for t, _ in times["snapshot"]]
    roll_ms = [t for t, _ in times["rollback"]]
    log(f"fp16-guard: {FP16_STEPS} steps through fit (the probe's checks "
        f"in them) in {time.perf_counter() - t_fit:.2f} s; 8 more guarded "
        f"steps: median {ms_step:.3f} ms a step, {tok_s:.1f} tokens/s; mean "
        f"{mean_ms:.3f} ms with 2 snapshots in them "
        f"({b * s / (mean_ms / 1e3):.1f} tokens/s); steps "
        f"{['%.3f' % x for x in step_ms]}; peak {peak_gb:.2f} GiB; "
        f"snapshots "
        f"{['%.1f ms at step %d' % x for x in times['snapshot']]} (the first "
        f"allocates the pinned ring), rollback "
        f"{['%.1f ms at step %d' % x for x in times['rollback']]}; "
        f"rolled back at step {r_step} to step {snap_step}'s snapshot, bit "
        f"for bit in the same tensors; skipped {skipped} of the fit's "
        f"{FP16_STEPS} ({len(natural)} natural); one graph; recorded "
        f"{recorded}")
    prof = profile_grouped(torch, "fp16-guard", "one guarded float16 step",
                           lambda: m.train_batch(*next(iter(
                               m._feed(m._loaders["train"])))),
                           LM_TRAIN_GROUPS)
    out = dict(launches=launches, recorded=recorded, ms_per_step=ms_step,
               mean_ms=mean_ms, step_ms=step_ms,
               tok_s=tok_s, peak_gb=peak_gb, snapshot_ms=snap_ms,
               rollback_ms=roll_ms, rolled_back_at=r_step,
               snapshot_step=snap_step, natural_overflows=[
                   r["step"] for r in natural],
               outcomes=outcomes, scales=[r["scale"] for r in rows],
               losses=[r["loss"] for r in rows],
               busy_share=prof.get("busy_share"),
               leaf_shapes=[(n, tuple(p.shape)) for n, p in named])
    del m, eng, model, probe, rec
    torch.cuda.empty_cache()
    return out


def _fp16_eager_vs_captured(torch):
    """Two Engines from one seed, float16 O1 under a guard with a
    GradScaler, eager (capture=False) and captured: 3 steps without faults,
    losses and every parameter, slot and the scale bit for bit."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import TrainGuard
    engines, models = {}, {}
    for mode, capture in (("eager", False), ("captured", None)):
        model, cfg = _fp16_gpt(torch, "cuda")
        models[mode] = model
        engines[mode] = Engine(
            model, loss=GPTPretrainingCriterion(),
            optimizer=AdamW(1e-4, weight_decay=0.01, fused_kernel=True),
            amp_dtype=torch.float16, capture=capture,
            guard=TrainGuard(**FP16_GUARD, scaler=GradScaler(**FP16_SCALER)))
    ids, labels = _batch(cfg, 8, 1024, "cuda")
    for step in range(3):
        losses = {k: e.train_batch([ids], [labels])[0].clone()
                  for k, e in engines.items()}
        torch.cuda.synchronize()
        check(torch.equal(losses["eager"], losses["captured"]),
              f"fp16-guard: eager vs captured step {step + 1}: loss "
              f"{losses}")
        ee, ce = engines["eager"], engines["captured"]
        same = all(torch.equal(a, b) for a, b in zip(
            models["eager"].parameters(), models["captured"].parameters()))
        slots = all(torch.equal(t, ce.optimizer._state[n][k])
                    for n, st in ee.optimizer._state.items()
                    for k, t in st.items())
        scale = torch.equal(ee._scaler_state["scale"],
                            ce._scaler_state["scale"])
        check(same and slots and scale and ee.guard.last_outcome == "ok",
              f"fp16-guard: eager vs captured after step {step + 1}: "
              f"parameters {same}, slots {slots}, scale {scale}, outcome "
              f"{ee.guard.last_outcome}")
    check(engines["captured"].captures and not engines["eager"].captures,
          "fp16-guard: the captured Engine does not record")
    log("fp16-guard: eager vs captured, 3 guarded float16 steps without "
        "faults: losses, every parameter, every slot and the scale bit for "
        "bit")
    del engines, models
    torch.cuda.empty_cache()


def _fp16_eager_o2(torch):
    """amp.decorate(O2, float16) and the eager GradScaler API, 3 steps."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.optimizer import AdamW
    model, cfg = _fp16_gpt(torch, "cuda")
    opt = AdamW(1e-4, weight_decay=0.01, fused_kernel=True,
                parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    check(all(p.dtype == torch.float16 for p in model.parameters())
          and opt._multi_precision, "fp16-guard: decorate(O2) left a "
          "parameter in another dtype or no master weights")
    scaler = amp.GradScaler(**FP16_SCALER)
    crit = GPTPretrainingCriterion()
    ids, labels = _batch(cfg, 8, 1024, "cuda")
    for w in WRAPPERS:
        w.launches = 0
    out = []
    for _ in range(3):
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = crit(model(ids), labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        out.append((loss.detach().item(), scaler._scale,
                    scaler._found_inf))
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in WRAPPERS}
    layers = cfg.num_hidden_layers
    for w, _ in GPT_GRAPH_KERNELS:
        check(launches[w] == 3 * layers, f"fp16-guard: eager O2 {w} "
              f"launched {launches[w]} times in 3 steps, want {3 * layers}")
    masters = [st["master"] for st in opt._state.values()]
    check(len(masters) == len(list(model.parameters())) and all(
        t.dtype == torch.float32 for t in masters), "fp16-guard: eager O2 "
        "keeps no f32 master for every parameter")
    good = [x for x, _, inf in out if not inf]
    check(good and all(math.isfinite(x) for x in good),
          f"fp16-guard: eager O2 losses {out}")
    log(f"fp16-guard: eager O2 (decorate float16, f32 masters), 3 steps of "
        f"scale(loss).backward(), step, update: (loss, scale, found_inf) "
        f"{out}; #1/#3/#4 float16 {3 * layers} launches each; #10 "
        f"{launches['fused_adamw_multi_update']} (master weights take the "
        "plain update)")
    del model, opt
    torch.cuda.empty_cache()
    return out


def _fp16_cpu_check(torch):
    """A 2-layer gpt3-345M (hidden 1024, 16 heads) step at 1 x 128, float16
    under the guard, on the card and on the CPU from the same weights and
    batch (_fp16_cross_device); the key projection's bias, whose gradient
    is zero in exact arithmetic (it shifts each query's scores by the same
    q.b, which softmax cancels), held to 1e-2 of the query projection's
    bias's on each device. The vocabulary is cut to 4096: the host's
    float16 matrix products run at ~1 GFLOP/s (PyTorch's CPU fallback
    where the CPU has no float16 instructions: one [128 x 1024] x [1024 x
    50304] product took 9.2 s, a 2-layer step with the full vocabulary 71
    s), and the LM head is the largest of them."""
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    cut = dict(num_hidden_layers=2, vocab_size=4096)
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev], cfg = _fp16_gpt(torch, dev, **cut)
    ids, labels = _batch(cfg, 1, 128, "cpu")

    def make(model):
        return _fp16_guard_engine(lambda guard: Engine(
            model, loss=GPTPretrainingCriterion(),
            optimizer=AdamW(1e-4, weight_decay=0.01, fused_kernel=True),
            amp_dtype=torch.float16, guard=guard))
    return _fp16_cross_device(
        torch, "fp16-guard", "2-layer float16 step (vocabulary 4096)",
        models, make, [ids], [labels],
        zero=("attn.k_proj.bias", ("k_proj", "q_proj")))


def phase_fp16_guard(torch, flush):
    """Phase fp16-guard: #1/#3/#4 in float16 held to their twins (GPT's
    training shape and D = 128, timed beside SDPA in float16; ragged,
    kv_lens and head-dim cases; the keep mask; an overflow case), the
    float16 refusals still standing (#2, #5, #1 at head_dim 32), #10
    guarded, then gpt3-345M float16 AMP training under TrainGuard with a
    GradScaler through Model.fit (FP16_*), its fused_ln block (#6/#7) in
    float16 under the same guard, eager vs captured, the eager O2 API and
    a cut check against the CPU."""
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    from paddle_tpu_torch import seed
    gen = torch.Generator(device="cuda").manual_seed(22)
    t0 = time.perf_counter()

    def part(name):
        log(f"fp16-guard: {name} done at {time.perf_counter() - t0:.1f} s "
            "into the phase")
    _check_keep_mask(torch, 128, 128, "float16", gen)
    rows = [_flash_train_case(torch, 8, 16, 1024, 1024, 64, "float16", None,
                              0.1, gen, flush, timed=True),
            _flash_train_case(torch, 4, 16, 1024, 1024, 128, "float16",
                              None, 0.1, gen, flush, timed=True),
            _flash_train_case(torch, 2, 4, 256, 256, 64, "float16",
                              [200, 256], 0.1, gen, flush, False),
            _flash_train_case(torch, 1, 8, 256, 256, 128, "float16", [0],
                              0.1, gen, flush, False),
            _flash_train_case(torch, 1, 2, 64, 64, 256, "float16", [50],
                              0.1, gen, flush, False),
            _flash_train_case(torch, 1, 4, 320, 96, 64, "float16", None,
                              0.0, gen, flush, False, causal=False)]
    for sq, sk, causal in RAGGED_SHAPES[:6]:
        rows.append(_flash_train_case(torch, 3, 2, sq, sk, 64, "float16",
                                      [0, sk // 2 + 1, sk], 0.1, gen, flush,
                                      False, causal=causal))
    _log_flash_rows("fp16-guard", rows)
    part("the flash cases")
    overflow = _f16_overflow_case(torch, gen)
    refused = _f16_refusals(torch, gen)
    shapes = _leaf_shapes(torch, lambda: GPTForCausalLM(
        _resolve_config("gpt3-345M"), device="cuda",
        generator=seed(0, device="cuda")))
    adamw = _adamw_guarded_case(torch, shapes, gen, flush)
    torch.cuda.empty_cache()
    part("#10 guarded")
    main = _fp16_main_run(torch, gen)
    part("the main run")
    gpt_ln = _fp16_gpt_fused_ln(torch)
    part("gpt fused_ln")
    _fp16_eager_vs_captured(torch)
    part("eager vs captured")
    o2 = _fp16_eager_o2(torch)
    part("eager O2")
    cpu = _fp16_cpu_check(torch)
    part("the cpu check")
    return dict(rows=rows, overflow=overflow, refused=refused, adamw=adamw,
                main=main, gpt_fused_ln=gpt_ln, o2=o2, cpu=cpu)


# -- float16 #6-#9 and #11 (phase fp16-kernels) -------------------------------

# #6-#9 in float16: (n, h) at ERNIE's and GPT's rows, ragged widths (100:
# rows of 200 bytes; 1000: 125 chunks a row), a wide row (2048, GPT-1.3B's)
# and one that is not a 16-byte multiple (3000)
LN_F16 = ((16384, 768), (8192, 1024), (7, 100), (16384, 1000), (4096, 2048),
          (7, 3000))
# ... the backward's residency against its plan at these widths
LN_F16_RESIDENCY = (100, 768, 1000, 1024, 2048, 3000, 8192)


def _ln_f16_overflow(torch, gen):
    """#6-#9 in float16 with x and r near 3.3e4, so that x + r passes
    65504 in about half the places: #6 stores s as +inf at the twin's
    places and y stays finite (the statistics are taken on the f32 sum);
    #9, which adds x + r again in f32, gives a finite dx; #7, reading the
    stored s back, is non-finite at exactly the twin's places (+inf, -inf
    and NaN apart). Every finite value within F16_ULPS of the twin's."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    n, h, f16 = 4096, 768, torch.float16

    def mk(scale=1.0, shift=0.0, shape=(n, h)):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                + shift).to(f16)
    x, r = mk(1e3, 3.3e4), mk(1e3, 3.3e4)
    dy, ds = mk(), mk()
    g, b = mk(0.1, 1.0, (h,)), mk(0.1, 0.0, (h,))
    y, s, mu, rstd = kln.fused_add_layer_norm_fwd(x, r, g, b, 1e-5)
    dx, _, _ = kln.fused_add_layer_norm_bwd(dy, ds, s, mu, rstd, g)
    y8, mu8, rstd8 = kln.fused_add_layer_norm_y_fwd(x, r, g, b, 1e-5)
    dx9, _, _ = kln.fused_add_layer_norm_y_bwd(dy, x, r, mu8, rstd8, g)
    torch.cuda.synchronize()
    t6 = kln.fused_add_layer_norm_fwd_plain(x, r, g, b, 1e-5)
    t7 = kln.fused_add_layer_norm_bwd_plain(dy, ds, s, mu, rstd, g)
    t8 = kln.fused_add_layer_norm_y_fwd_plain(x, r, g, b, 1e-5)
    t9 = kln.fused_add_layer_norm_y_bwd_plain(dy, x, r, mu8, rstd8, g)
    n_inf = int(torch.isposinf(t6[1]).sum())
    check(0 < n_inf < n * h, f"fp16-kernels: the LN overflow case has "
          f"{n_inf} infinite sums: nothing to hold")
    out = dict(s_inf=n_inf)
    for name, a, p in (("#6 y", y, t6[0]), ("#6 s", s, t6[1]),
                       ("#8 y", y8, t8[0]), ("#9 dx", dx9, t9[0])):
        out[name] = f16_ulps(a, p)
        check(out[name] <= F16_ULPS, f"fp16-kernels: LN overflow case: "
              f"{name} {out[name]} float16 ulps from the twin's (or at "
              f"other non-finite places)")
    check(bool(torch.isfinite(y).all() and torch.isfinite(y8).all()
               and torch.isfinite(dx9).all()), "fp16-kernels: LN overflow "
          "case: y or #9's dx is not finite")
    for what, f in (("+inf", torch.isposinf), ("-inf", torch.isneginf),
                    ("NaN", torch.isnan)):
        n_diff = int((f(dx) != f(t7[0])).sum())
        check(n_diff == 0, f"fp16-kernels: LN overflow case: #7's dx {what} "
              f"differs from the twin's at {n_diff} places")
    fin = torch.isfinite(t7[0])
    out["#7 dx non-finite"] = int((~fin).sum())
    out["#7 dx"] = f16_ulps(dx[fin], t7[0][fin])
    check(out["#7 dx"] <= F16_ULPS, f"fp16-kernels: LN overflow case: #7's "
          f"finite dx {out['#7 dx']} ulps from the twin's")
    log(f"fp16-kernels: #6-#9 float16 overflow case ({n} x {h}, x and r "
        f"near 3.3e4): {n_inf} sums stored as +inf at the twin's places, y "
        f"finite; #9's dx finite; #7's dx non-finite at "
        f"{out['#7 dx non-finite']} places, each as the twin's; "
        + ", ".join(f"{k} {v:.2f} ulps" for k, v in out.items()
                    if k.startswith("#") and "non-finite" not in k))
    return out


def _conv_f16_overflow(torch, gen):
    """#11 in float16 with scale 1e4 and shift 6e4, so that part of y
    passes 65504: +inf at the twin's places (the epilogue's store rounds
    to nearest without saturation: 65520 and up become inf), except where
    the f32 value lies within F16_ULPS float16 ulps (32 each there) of
    that threshold, where the two sums' orders may round either way; no
    NaN; the finite rest within F16_ULPS of the twin's."""
    from paddle_tpu_torch.ops.kernels import conv_bn_act as kcb
    m, cin, cout, f16 = 12544, 512, 2048, torch.float16
    x2 = torch.randn(m, cin, generator=gen, device="cuda").to(f16)
    w = (torch.randn(cin, cout, generator=gen, device="cuda")
         / math.sqrt(cin)).to(f16)
    scale = 1e4 * (1.0 + 0.1 * torch.randn(cout, generator=gen,
                                           device="cuda"))
    shift = 6e4 + 0.1 * torch.randn(cout, generator=gen, device="cuda")
    r2 = torch.randn(m, cout, generator=gen, device="cuda").to(f16)
    y = kcb.fused_conv1x1_bn_act(x2, w, scale, shift, r2, True)
    torch.cuda.synchronize()
    t = kcb.conv_bn_act_plain(x2, w, scale, shift, r2, True)
    y32 = kcb.conv_bn_act_plain(x2.float(), w.float(), scale, shift,
                                r2.float(), True)
    n_inf = int(torch.isposinf(t).sum())
    check(0 < n_inf < m * cout, f"fp16-kernels: #11's overflow case has "
          f"{n_inf} infinite outputs: nothing to hold")
    edge = (y32 - 65520.0).abs() <= F16_ULPS * 32.0
    n_diff = int(((torch.isposinf(y) != torch.isposinf(t)) & ~edge).sum())
    n_edge = int(((torch.isposinf(y) != torch.isposinf(t)) & edge).sum())
    check(n_diff == 0 and not bool(torch.isnan(y).any()),
          f"fp16-kernels: #11's overflow case: +inf differs from the twin's "
          f"at {n_diff} places away from the threshold")
    fin = torch.isfinite(t) & torch.isfinite(y)
    err, scaled = _err(y[fin], t[fin])
    ulps = f16_ulps(y[fin], t[fin])
    check(ulps <= F16_ULPS, f"fp16-kernels: #11's overflow case: finite "
          f"values {ulps} float16 ulps of max(1, |twin|) from the twin's")
    log(f"fp16-kernels: #11 float16 overflow case (M={m} {cin}->{cout}, "
        f"scale 1e4, shift 6e4): {n_inf} outputs +inf at the twin's places "
        f"but {n_edge} of the {int(edge.sum())} whose f32 value lies within "
        f"{F16_ULPS} float16 ulps of 65520, none NaN; the finite ones within "
        f"{ulps:.2f} ulps ({scaled:.3e} of max(1, |twin|))")
    return dict(inf=n_inf, edge_flips=n_edge, scaled_err=scaled, ulps=ulps,
                max_abs_err=err)


def phase_fp16_kernels(torch, flush):
    """#6-#9 and #11 in float16 against their twins: the LN kernels at
    LN_F16 (gamma/beta float16 and f32, eps 1e-12 and 1e-5; rows off a
    16-byte boundary), their backward's residency against its plan, an
    overflow case; #11 at the 12 shapes of a ResNet-50 forward at batch
    256 x 224 px, ragged shapes and an overflow case. Each timed beside its
    bf16 instantiation (the same call) and its bound: the LN kernels at
    ERNIE's and GPT's rows, #11 at the 12 shapes summed over a forward's
    32 and a training forward's 17 launches."""
    from paddle_tpu_torch.ops.kernels import fused_ln as kln
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    for k, (n, h) in enumerate(LN_F16):
        for j, eps in enumerate((1e-12, 1e-5)):
            w_dtype = "float16" if (k + j) % 2 else "float32"
            rows.append(_ln_case(torch, n, h, "float16", w_dtype, eps, gen))
    for n, h in ((8192, 1023), (4096, 3000)):
        rows.append(_ln_case(torch, n, h, "float16", "float16", 1e-5, gen,
                             offset=True))
    for r in rows:
        errs = " ".join(f"{k} {v:.2e}" for k, v in r["err"].items())
        log(f"fp16-kernels: #6-#9 float16 n{r['n']} h{r['h']} gamma "
            f"{r['w_dtype']} eps {r['eps']}"
            + (" offset" if r["offset"] else "") + f": {errs}")
    worst_ulps = max(v for r in rows for k, v in r["err"].items()
                     if k.endswith("_ulps"))
    for h in LN_F16_RESIDENCY:
        for with_sum in (True, False):
            plan = kln.bwd_plan(16384, h, torch.float16)
            res = kln.bwd_residency(h, torch.float16, with_sum)
            check(plan == kln.bwd_plan(16384, h, torch.bfloat16)
                  and (res["blocks_per_sm"] == plan.blocks_per_sm
                       if h > 1024 else
                       res["blocks_per_sm"] >= plan.blocks_per_sm)
                  and res["smem"] == plan.smem and res["spill_bytes"] == 0,
                  f"fp16-kernels: the float16 backward at h {h} resides "
                  f"{res} against its plan {plan}")
    log(f"fp16-kernels: #6-#9 float16 against their twins in {len(rows)} "
        f"cases, the worst {worst_ulps:.2f} float16 ulps of max(1, |twin|) "
        f"(bar {F16_ULPS}); a second backward bit for bit in each; the "
        f"backward resides as bf16's plan counts on at h "
        f"{LN_F16_RESIDENCY}")
    overflow = _ln_f16_overflow(torch, gen)
    timing = {}
    for shape, (n, h) in (("ernie", (16384, 768)), ("gpt", (8192, 1024))):
        timing[shape] = {dt: _ln_timing(torch, n, h, gen, flush, dt)
                         for dt in ("bfloat16", "float16")}
        for k in timing[shape]["float16"]["ms"]:
            f16, bf = timing[shape]["float16"], timing[shape]["bfloat16"]
            bms, by = f16["bound"][k]
            log(f"fp16-kernels: {shape} shape {k}: float16 ms "
                f"{f16['ms'][k]:.4f} (bf16 {bf['ms'][k]:.4f}, "
                f"{f16['ms'][k] / bf['ms'][k]:.3f}x) plain_ms "
                f"{f16['plain_ms'][k]:.4f} bound_ms {bms:.4f} ({by})")
        log(f"fp16-kernels: {shape} shape native_layer_norm_backward in "
            f"float16 ms {timing[shape]['float16']['native_bwd_ms']:.4f}")
    # #11
    crows = []
    for m, cin, cout, res, _ in SERVE_SHAPES:
        crows.append(_conv_case(torch, m, cin, cout, res, True, "float16",
                                gen, flush, True))
        crows[-1]["bf16_ms"] = _conv_case(torch, m, cin, cout, res, True,
                                          "bfloat16", gen, flush, True)["ms"]
    ragged = []
    for m, cin, cout, res, off in ((1000, 100, 70, True, 0),
                                   (129, 8, 9, False, 0), (7, 3, 1, True, 0),
                                   (12545, 512, 2048, True, 0),
                                   (1000, 64, 70, True, 1)):
        ragged.append(_conv_case(torch, m, cin, cout, res, True, "float16",
                                 gen, flush, False, offset=off))
    for r in crows + ragged:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} (bf16 {r['bf16_ms']:.4f}) bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) plain_ms "
            f"{r['plain_ms']:.4f} GEMM alone {r['gemm_ms']:.4f}")
        log(f"fp16-kernels: #11 float16 M={r['m']} {r['cin']}->{r['cout']} "
            f"res={r['res']} offset={r['offset']} max_abs_err "
            f"{r['max_abs_err']:.3e} ({r['ulps']:.2f} float16 ulps of max(1, "
            f"|twin|))" + extra)
    total = _shape_sum(crows, [n for *_, n in SERVE_SHAPES])
    train = _shape_sum(crows, [TRAIN_SHAPES.get(i, 0)
                               for i in range(len(SERVE_SHAPES))])
    for t, counts in ((total, [n for *_, n in SERVE_SHAPES]),
                      (train, [TRAIN_SHAPES.get(i, 0)
                               for i in range(len(SERVE_SHAPES))])):
        t["bf16_ms"] = sum(r["bf16_ms"] * n for r, n in zip(crows, counts))
    for what, t in (("the 32 launches of one ResNet-50 forward", total),
                    ("the 17 launches of one training forward", train)):
        log(f"fp16-kernels: #11 float16, {what} (batch 256, 224 px): "
            f"{t['ms']:.4f} ms (bf16 {t['bf16_ms']:.4f}, "
            f"{t['ms'] / t['bf16_ms']:.3f}x) against a bound of "
            f"{t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.3f} of it); "
            f"twin {t['plain_ms']:.4f} ms; GEMM alone {t['gemm_ms']:.4f} ms")
    coverflow = _conv_f16_overflow(torch, gen)
    return dict(ln_rows=rows, ln_ulps=worst_ulps, ln_overflow=overflow,
                ln_timing=timing, conv_rows=crows + ragged,
                conv_total=total, conv_train_total=train,
                conv_overflow=coverflow)


# -- float16 AMP training of ERNIE-3.0-base and ResNet-50 ---------------------

# kernel-node name fragments of a float16 ERNIE step's graph (with the
# mangled __half): #8/#9 twice a layer, #1/#3/#4 once, #10 once a step
ERNIE_GRAPH_KERNELS = (("fused_add_layer_norm_y_fwd", "ln_fwd_kernel"),
                       ("fused_add_layer_norm_y_bwd", "ln_bwd_kernel")
                       ) + GPT_GRAPH_KERNELS
# ... and of GPT's fused_ln block: #6/#7 once a layer
GPT_LN_GRAPH_KERNELS = (("fused_add_layer_norm_fwd", "ln_fwd_kernel"),
                        ("fused_add_layer_norm_bwd", "ln_bwd_kernel"))


def _f16_nodes(torch, eng, frags):
    """{wrapper: float16 kernel nodes of the Engine's one guarded
    recording whose name holds its fragment}, #10's adamw_kernel nodes
    beside."""
    rec = next((r for k, r in eng._recorded.items()
                if k[0][0] == "guarded"), None)
    check(rec is not None and rec.graph is not None,
          "the Engine holds no recorded guarded step")
    nodes = _graph_node_names(torch, rec.graph)
    out = {w: sum(frag in n and F16_MANGLED in n for n in nodes)
           for w, frag in frags}
    out["adamw_kernel"] = sum("adamw_kernel" in n for n in nodes)
    return out


def _collect(torch):
    """Free what earlier phases left in reference cycles (an Engine and
    its graph's pool wait for the cycle collector), so that a peak read
    after it counts this run's tensors: GiB collected."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return (before - torch.cuda.memory_allocated()) / 2 ** 30


def _guarded_steps_ms(torch, step, n=8):
    """ms of ``n`` more guarded steps, each synchronized: (median, mean,
    all)."""
    import statistics
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out), statistics.mean(out), out


def _fp16_ernie_run(torch):
    """ERNIE-3.0-base pretraining, float16 O1, captured, under
    TrainGuard(FP16_GUARD, GradScaler(FP16_SCALER)) with nan_grads over
    FP16_STORM, through the Engine at batch 32 x 512 (phase ernie's
    model, batch and optimizer)."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nlp.ernie import _resolve_config
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.resilience import TrainGuard, faults
    tag, b, s = "fp16-ernie", 32, 512
    cfg = _resolve_config("ernie-3.0-base-zh", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    guard = TrainGuard(**FP16_GUARD, scaler=GradScaler(**FP16_SCALER))
    collected = _collect(torch)
    t0 = time.perf_counter()
    model, eng = _ernie_engine(torch, cfg, "cuda", amp=torch.float16,
                               capture=None, guard=guard)
    inputs, labels = _ernie_batch(cfg.vocab_size, b, s, "cuda")
    torch.cuda.synchronize()
    log(f"{tag}: ernie-3.0-base-zh built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters, "
        f"{cfg.num_hidden_layers} layers, fused_ln); batch {b} x {s}, "
        f"float16 O1, AdamW(1e-4, weight_decay=0.01, fused_kernel=True), "
        f"TrainGuard({FP16_GUARD}, GradScaler({FP16_SCALER})), captured, "
        f"nan_grads at steps {FP16_STORM[0]}-{sum(FP16_STORM) - 1}; "
        f"{collected:.2f} GiB of earlier phases' garbage collected first")
    named = list(model.named_parameters())
    probe = _GuardProbe(torch, eng, [named[i][1] for i in
                                     (0, len(named) // 2, len(named) - 1)])
    times = _timed_guard(torch, guard)
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    with faults.scenario(("nan_grads", {"step": FP16_STORM[0],
                                        "count": FP16_STORM[1]})):
        for _ in range(FP16_STEPS):
            loss = eng.train_batch(inputs, labels)[0]
            probe.batch_end({"loss": [loss.item()]})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g = _check_guarded(tag, probe, guard, times)
    layers = cfg.num_hidden_layers
    recorded = _f16_nodes(torch, eng, ERNIE_GRAPH_KERNELS)
    want = {"fused_add_layer_norm_y_fwd": 2 * layers,
            "fused_add_layer_norm_y_bwd": 2 * layers,
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "adamw_kernel": 1}
    check(recorded == want, f"{tag}: the recorded step holds {recorded} "
          f"(float16 nodes), want {want}")
    # the wrappers ran at the eager first step and at the recording
    calls = {("fused_adamw_multi_update" if k == "adamw_kernel" else k):
             2 * v for k, v in want.items()}
    others = {k: c for k, c in launches.items() if c and k not in calls}
    check({k: launches[k] for k in calls} == calls and not others,
          f"{tag}: wrapper launches {launches}, want {calls} and no other")
    ms, mean_ms, step_ms = _guarded_steps_ms(
        torch, lambda: eng.train_batch(inputs, labels))
    prof = profile_grouped(torch, tag, "one guarded float16 step",
                           lambda: eng.train_batch(inputs, labels),
                           LM_TRAIN_GROUPS)
    snap_ms = [t for t, _ in times["snapshot"]]
    roll_ms = [t for t, _ in times["rollback"]]
    log(f"{tag}: {FP16_STEPS} guarded steps (each read by the probe) in "
        f"{run_s:.2f} s; 8 more: median {ms:.3f} ms a step = "
        f"{b * s / (ms / 1e3):.1f} tokens/s, mean {mean_ms:.3f} ms with "
        f"snapshots in them; steps {['%.3f' % x for x in step_ms]}; peak "
        f"{peak:.2f} GiB; snapshots "
        f"{['%.1f ms at step %d' % x for x in times['snapshot']]}, rollback "
        f"{['%.1f ms at step %d' % x for x in times['rollback']]}; rolled "
        f"back at step {g['r_step']} to step {g['snap_step']}'s snapshot; "
        f"{len(g['natural'])} natural overflows; one graph holding "
        f"{recorded}")
    out = dict(launches=launches, recorded=recorded, ms_per_step=ms,
               mean_ms=mean_ms, step_ms=step_ms, tok_s=b * s / (ms / 1e3),
               peak_gb=peak, snapshot_ms=snap_ms, rollback_ms=roll_ms,
               rolled_back_at=g["r_step"], snapshot_step=g["snap_step"],
               natural_overflows=[r["step"] for r in g["natural"]],
               outcomes=g["outcomes"],
               scales=[r["scale"] for r in probe.rows],
               losses=[r["loss"] for r in probe.rows], **prof)
    del model, eng, probe
    torch.cuda.empty_cache()
    return out


def _fp16_cross_device(torch, tag, what, models, make_engine, inputs,
                       labels, zero=None, leaf_bar=None, ratio_bar=None,
                       kernels=(), updates=False):
    """One guarded float16 step of ``make_engine(model)`` (scaler init
    1024, incr_every 2) on the card and on the CPU from the CPU model's
    weights and the same batch, then a nan_grads step on the card. Held:
    each leaf's unscaled gradient (what the optimizer receives times the
    GradScaler's 1/scale) in relative L2 and the gradient-norm telemetry
    at the float16 bar of 1e-2; the loss 1e-3 relative; each parameter
    within 1e-3 of max(1, |cpu|) after the step (Adam's first step moves
    an element by about lr whatever its gradient: a gross fault only); the
    skipped step leaves the card's parameters unchanged and halves the
    scale. ``zero``: (name suffix, (from, to)) of leaves whose gradient is
    zero in exact arithmetic, held to 1e-2 of the partner leaf named by
    replacing ``from`` with ``to``, on each device. ``leaf_bar``: name ->
    the relative L2 bar of that leaf, in place of 1e-2; ``ratio_bar``:
    each leaf's gradient norm, card over CPU, within it of 1.
    ``kernels``: wrappers that the card's step must launch. ``updates``:
    each leaf's update p_t - p_(t-1) held as its gradient is, in place of
    the parameters (Momentum's first update is lr times the gradient)."""
    from paddle_tpu_torch.resilience import faults
    leaf_bar = leaf_bar or (lambda n: 1e-2)
    with torch.no_grad():
        for a, b in zip(models["cuda"].parameters(),
                        models["cpu"].parameters()):
            a.copy_(b)
    engs = {dev: make_engine(m) for dev, m in models.items()}
    start = [p.detach().clone() for p in models["cpu"].parameters()]
    grads, losses = {}, {}
    t0 = time.perf_counter()
    for dev, e in engs.items():
        e.enable_grad_norm()
        if dev == "cuda":
            _zero_launches()
        opt = e.optimizer
        inner = opt._clip_update

        def spy(names, params, gs, scale=None, norm=None, skip=None,
                dev=dev, inner=inner):
            grads[dev] = {n: (g.float() * scale).cpu()
                          for n, g in zip(names, gs)}
            return inner(names, params, gs, scale=scale, norm=norm,
                         skip=skip)
        opt._clip_update = spy
        try:
            losses[dev] = float(e.train_batch(inputs, labels)[0])
        finally:
            del opt._clip_update
        if dev == "cuda":
            launched = _read_launches()
            check(all(launched[k] for k in kernels), f"{tag}: cpu check: "
                  f"the card's step launched {launched}, want each of "
                  f"{kernels}")
    secs = time.perf_counter() - t0
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    check(rel <= 1e-3, f"{tag}: cpu check: loss {losses} ({rel})")
    norms = {d: float(e.last_grad_norm) for d, e in engs.items()}
    norm_rel = abs(norms["cuda"] - norms["cpu"]) / norms["cpu"]
    check(norm_rel <= 1e-2, f"{tag}: cpu check: the unscaled gradients' "
          f"norms {norms} ({norm_rel})")
    check(set(grads["cuda"]) == set(grads["cpu"]) == {
        n for n, _ in models["cpu"].named_parameters()},
        f"{tag}: cpu check: the optimizer did not see every leaf")
    grad_l2, zero_ratio, norm_ratio = {}, {}, {}
    for n, want in grads["cpu"].items():
        got = grads["cuda"][n]
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"{tag}: cpu check: {n}'s gradient is not finite")
        if zero is not None and n.endswith(zero[0]):
            partner = n.replace(*zero[1])
            for dev in grads:
                r = (grads[dev][n].norm() / grads[dev][partner].norm()).item()
                zero_ratio[f"{dev} {n}"] = r
                check(r <= 1e-2, f"{tag}: cpu check: {dev} {n}'s gradient is "
                      f"{r} of {partner}'s, not rounding noise")
            continue
        grad_l2[n] = ((got - want).norm() / want.norm()).item()
        check(grad_l2[n] <= leaf_bar(n), f"{tag}: cpu check: {n}'s unscaled "
              f"gradient {grad_l2[n]} relative L2 from the CPU's (bar "
              f"{leaf_bar(n)})")
        if ratio_bar is not None:
            norm_ratio[n] = (got.norm() / want.norm()).item() - 1.0
            check(abs(norm_ratio[n]) <= ratio_bar, f"{tag}: cpu check: "
                  f"{n}'s unscaled gradient norm {norm_ratio[n]:+} from the "
                  f"CPU's, over {ratio_bar}")
    worst = 0.0
    for (n, a), b, p0 in zip(models["cuda"].named_parameters(),
                             models["cpu"].parameters(), start):
        if updates:
            got, want = a.detach().cpu() - p0, b.detach() - p0
            scaled = ((got - want).norm() / want.norm()).item()
            check(scaled <= leaf_bar(n), f"{tag}: cpu check: {n}'s update "
                  f"{scaled} relative L2 from the CPU's")
        else:
            diff = (a.detach().cpu() - b.detach()).abs()
            scaled = (diff / b.detach().abs().clamp_min(1.0)).max().item()
            check(scaled <= 1e-3, f"{tag}: cpu check: {n} differs by "
                  f"{scaled} of max(1, |cpu|) after the step")
        worst = max(worst, scaled)
    before = [p.detach().clone() for p in models["cuda"].parameters()]
    with faults.scenario(("nan_grads", {"step": 2})):
        engs["cuda"].train_batch(inputs, labels)
    check(engs["cuda"].guard.last_outcome == "skipped" and all(
        torch.equal(a, b) for a, b in zip(models["cuda"].parameters(),
                                          before)),
        f"{tag}: cpu check: the step with nan_grads was not a no-op")
    scale = float(engs["cuda"]._scaler_state["scale"])
    check(scale == 512.0, f"{tag}: cpu check: scale {scale}")
    top = sorted(grad_l2.items(), key=lambda kv: -kv[1])[:3]
    l2 = sorted(grad_l2.values())
    ratio_worst = max(norm_ratio.items(), key=lambda kv: abs(kv[1]),
                      default=None)
    log(f"{tag}: {what} cuda vs CPU: loss {rel:.3e} relative; the unscaled "
        f"gradients' norm {norm_rel:.3e} relative ({norms['cuda']:.6g} vs "
        f"{norms['cpu']:.6g}); each leaf's unscaled gradient in relative "
        f"L2, the median {l2[len(l2) // 2]:.3e}, the worst "
        + ", ".join(f"{n} {v:.3e}" for n, v in top)
        + ("" if ratio_worst is None else
           f"; each leaf's gradient norm, card over CPU, within "
           f"{abs(ratio_worst[1]):.3e} of 1 ({ratio_worst[0]})")
        + ("" if not zero_ratio else "; the leaves zero in exact "
           "arithmetic at " + ", ".join(f"{k} {v:.2e}" for k, v in
                                        zero_ratio.items())
           + " of their partners'")
        + (f"; each leaf's update within {worst:.3e} relative L2" if updates
           else f"; parameters within {worst:.3e} of max(1, |cpu|)")
        + "; the two steps "
        f"took {secs:.1f} s; a nan_grads step on the card skipped, scale "
        "1024 -> 512")
    return dict(loss_rel=rel, norm_rel=norm_rel, grad_l2_worst=top[0][1],
                grad_l2_median=l2[len(l2) // 2], grad_l2=grad_l2,
                norm_ratio=norm_ratio,
                zero_ratio=max(zero_ratio.values(), default=None),
                worst=worst)


def _fp16_guard_engine(make, init=1024.0):
    """``make(guard)`` with the cut checks' guard: snapshot_every 1,
    GradScaler(init_loss_scaling=init, incr_every_n_steps=2)."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import TrainGuard
    return make(TrainGuard(snapshot_every=1, scaler=GradScaler(
        init_loss_scaling=init, incr_every_n_steps=2)))


def _fp16_ernie_cpu(torch):
    """A 2-layer ERNIE-3.0-base (hidden 768, 12 heads, fused_ln, the
    vocabulary cut to 4096 as fp16-guard's cut check cuts GPT's) step at
    1 x 128, float16 under the guard, card against CPU
    (_fp16_cross_device)."""
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.ernie import (ErniePretrainingCriterion,
                                            _resolve_config)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = _resolve_config("ernie-3.0-base-zh", num_hidden_layers=2,
                          vocab_size=4096, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    models = {dev: _ernie_engine(torch, cfg, dev, weight_seed=1)[0]
              for dev in ("cpu", "cuda")}
    inputs, labels = _ernie_batch(cfg.vocab_size, 1, 128, "cpu")

    def make(model):
        return _fp16_guard_engine(lambda guard: Engine(
            model, loss=ErniePretrainingCriterion(),
            optimizer=AdamW(1e-4, weight_decay=0.01, fused_kernel=True),
            amp_dtype=torch.float16, guard=guard))
    return _fp16_cross_device(
        torch, "fp16-ernie", "2-layer float16 step (vocabulary 4096)",
        models, make, inputs, labels,
        zero=("attn.k_proj.bias", ("k_proj", "q_proj")))


def phase_fp16_ernie(torch):
    """Phase fp16-ernie: ERNIE-3.0-base float16 AMP pretraining under the
    guard (_fp16_ernie_run), eager against captured, and a cut step
    against the CPU."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nlp.ernie import _resolve_config
    from paddle_tpu_torch.resilience import TrainGuard
    t0 = time.perf_counter()
    main = _fp16_ernie_run(torch)
    log(f"fp16-ernie: the main run done at {time.perf_counter() - t0:.1f} s "
        "into the phase")
    cfg = _resolve_config("ernie-3.0-base-zh", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fused_ln=True)
    inputs, labels = _ernie_batch(cfg.vocab_size, 32, 512, "cuda")
    pair = _graph_pair(
        torch, "fp16-ernie eager vs captured",
        lambda cap: _ernie_engine(
            torch, cfg, "cuda", amp=torch.float16, capture=cap,
            guard=TrainGuard(**FP16_GUARD, scaler=GradScaler(
                **FP16_SCALER))),
        inputs, labels, LM_TRAIN_GROUPS, steps=3,
        expect={"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                "flash_attention_bwd_dkv": 12, "fused_adamw_multi_update": 1,
                "fused_add_layer_norm_y_fwd": 24,
                "fused_add_layer_norm_y_bwd": 24})
    pair.pop("engines")
    torch.cuda.empty_cache()
    log(f"fp16-ernie: eager vs captured done at "
        f"{time.perf_counter() - t0:.1f} s into the phase")
    cpu = _fp16_ernie_cpu(torch)
    log(f"fp16-ernie: the cpu check done at {time.perf_counter() - t0:.1f} "
        "s into the phase")
    torch.cuda.empty_cache()
    return dict(main=main, pair=pair, cpu=cpu)


def _fp16_resnet_run(torch):
    """resnet50 (NHWC, fused_bottleneck) trained through Model.fit at batch
    256 x 224 px, float16 O1, Momentum(0.1, 0.9), captured, under
    TrainGuard(RESNET_F16_GUARD, GradScaler(FP16_SCALER)) with nan_grads
    over RESNET_F16_STORM (the first steps overflow naturally: see
    RESNET_F16_GUARD)."""
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.resilience import TrainGuard, faults
    from paddle_tpu_torch.vision.models import resnet50
    tag, b, hw = "fp16-resnet", 256, 224
    collected = _collect(torch)
    t0 = time.perf_counter()
    net = resnet50(num_classes=1000, layout="NHWC", fused_bottleneck=True,
                   device="cuda", generator=seed(0, device="cuda"))
    guard = TrainGuard(**RESNET_F16_GUARD,
                       scaler=GradScaler(**FP16_SCALER))
    m = Model(net)
    m.prepare(Momentum(0.1, momentum=0.9), nn.CrossEntropyLoss(),
              amp_configs={"level": "O1", "dtype": "float16"}, guard=guard)
    eng = m._engine
    x, y = _resnet_train_batch(torch, b, hw, "cpu", seed=1)
    ds = _repeated_set(b * FP16_STEPS, x.numpy(), y.numpy())
    del x, y
    bufs = dict(net.named_buffers())
    stats0 = {n: t.clone() for n, t in bufs.items()}
    torch.cuda.synchronize()
    log(f"{tag}: resnet50 built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in net.parameters())} parameters, "
        f"{len(bufs)} running statistics; NHWC, fused_bottleneck); "
        f"Model.fit at {b} x 3 x {hw} x {hw}, float16 O1, Momentum(0.1, "
        f"0.9), TrainGuard({RESNET_F16_GUARD}, GradScaler({FP16_SCALER})), "
        f"captured, nan_grads at steps {RESNET_F16_STORM[0]}-"
        f"{sum(RESNET_F16_STORM) - 1}; {collected:.2f} GiB of earlier "
        "phases' garbage collected first")
    named = list(net.named_parameters())
    watch = [named[i][1] for i in (0, len(named) // 2, len(named) - 1)]
    watch += [bufs["bn1._mean"], bufs["layer4.2.bn3._variance"]]
    probe = _GuardProbe(torch, eng, watch)
    times = _timed_guard(torch, guard)
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    with faults.scenario(("nan_grads", {"step": RESNET_F16_STORM[0],
                                        "count": RESNET_F16_STORM[1]})):
        m.fit(ds, batch_size=b, epochs=1, shuffle=False, verbose=0,
              callbacks=[probe.callback])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g = _check_guarded(tag, probe, guard, times, RESNET_F16_GUARD,
                       RESNET_F16_STORM, overflow_after_rollback=True)
    recorded = _f16_nodes(torch, eng, (("fused_conv1x1_bn_act",
                                        "conv_bn_act_tc16_kernel"),))
    check(recorded == {"fused_conv1x1_bn_act": 17, "adamw_kernel": 0},
          f"{tag}: the recorded step holds {recorded} (float16 nodes), want "
          "17 of #11 and no #10")
    _only(tag, launches, "fused_conv1x1_bn_act", 2 * 17)
    check(all(t.dtype == torch.float32 for t in bufs.values()),
          f"{tag}: running statistics not f32")
    moved = sum(not torch.equal(bufs[n], t) for n, t in stats0.items())
    check(moved == len(stats0), f"{tag}: {len(stats0) - moved} running "
          "statistics did not move")
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          f"{tag}: parameters not f32")
    batch = next(iter(m._feed(m._loaders["train"])))
    ms, mean_ms, step_ms = _guarded_steps_ms(torch,
                                             lambda: m.train_batch(*batch))
    prof = profile_grouped(torch, tag, "one guarded float16 step",
                           lambda: m.train_batch(*batch), TRAIN_GROUPS)
    snap_ms = [t for t, _ in times["snapshot"]]
    roll_ms = [t for t, _ in times["rollback"]]
    log(f"{tag}: {FP16_STEPS} steps through fit (the probe's reads in them) "
        f"in {fit_s:.2f} s; 8 more guarded steps: median {ms:.3f} ms a "
        f"step = {b / (ms / 1e3):.1f} images/s, mean {mean_ms:.3f} ms with "
        f"snapshots in them; steps {['%.3f' % x for x in step_ms]}; peak "
        f"{peak:.2f} GiB; snapshots "
        f"{['%.1f ms at step %d' % x for x in times['snapshot']]}, rollback "
        f"{['%.1f ms at step %d' % x for x in times['rollback']]}; rolled "
        f"back at step {g['r_step']} to step {g['snap_step']}'s snapshot; "
        f"{len(g['natural'])} natural overflows; #11 float16 x 17 a step "
        f"in one graph, no other kernel of the port; {moved} f32 running "
        "statistics moved, unchanged on each skipped step")
    out = dict(launches=launches, recorded=recorded, ms_per_step=ms,
               mean_ms=mean_ms, step_ms=step_ms, images_per_s=b / (ms / 1e3),
               peak_gb=peak, snapshot_ms=snap_ms, rollback_ms=roll_ms,
               rolled_back_at=g["r_step"], snapshot_step=g["snap_step"],
               natural_overflows=[r["step"] for r in g["natural"]],
               outcomes=g["outcomes"],
               scales=[r["scale"] for r in probe.rows],
               losses=[r["loss"] for r in probe.rows], **prof)
    del m, eng, net, probe, batch
    torch.cuda.empty_cache()
    return out


def _cut_resnet(torch, device, generator):
    """ResNet(BottleneckBlock, 18, num_classes=10, NHWC, fused_bottleneck)
    cut after layer2 as tests/test_torch_fp16_resnet.py cuts it (layer3
    and layer4 identities, the classifier a 512 -> 10 Linear): the stem
    and four bottleneck blocks, whose 64 -> 256 and 128 -> 512 1x1 convs
    run through #11."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock, ResNet
    m = ResNet(BottleneckBlock, 18, num_classes=10, layout="NHWC",
               fused_bottleneck=True, device=device, generator=generator)
    m.layer3 = nn.Identity()
    m.layer4 = nn.Identity()
    m.fc = nn.Linear(512, 10, device=device, generator=generator)
    return m.train()


def _fp16_resnet_cpu(torch):
    """The cut ResNet (_cut_resnet) at batch 16 x 3 x 64 x 64 (layer2's
    BatchNorms over 1024 values a channel; labels mod 10), one guarded
    float16 Momentum(0.1, 0.9) step on the card and on the CPU from the
    same weights and batch (_fp16_cross_device: the loss at 1e-3, the
    gradient norm at 1e-2, the skip), with #11 launched on the card. The
    classifier's leaves, gradient and update, are held at 1e-2. Every
    other leaf's gradient passes back through a ReLU or the max-pool, and
    there a float16 step's gradient is not a continuous function of the
    weights: a ReLU whose input lies within rounding of zero, or a pool
    window whose two largest values do, passes or stops its element's
    gradient on one device and not on the other. In float64 on the CPU,
    this network's gradient moves linearly (8.5 times the perturbation on
    the median leaf) while its weights move by up to 1e-8 of themselves;
    at 5e-7 one ReLU of the 32768 at layer2's output flips, and the median
    leaf jumps by 1.1e-2 (the gradient there is spread over the 21278
    open ones, so one carries about 1/sqrt(21278) = 6.9e-3 of it, in
    relative L2); at 5e-4, about float16's rounding, it moves
    1.1e-1 at 4 x 32 px and 1.2e-1 at 16 x 64 px. The jump counts a
    fraction of the elements, so a larger batch does not shrink it. Two
    float16 steps on the CPU (#11's twin against aten's 1x1 convs) sat
    9.3e-2 apart on the median leaf and 1.28e-1 at worst, their norms
    1.9e-2 apart at worst. So each such leaf's gradient and update are
    held at RESNET_CUT_LEAF_BAR in relative L2, and its gradient norm,
    card over CPU, within RESNET_CUT_RATIO_BAR of 1: a leaf whose gradient
    is zeroed or doubled reads 1 on both (the same CPU comparison with
    one leaf's gradient zeroed or doubled failed both). The running
    statistics stay f32."""
    from paddle_tpu_torch import seed
    b, hw = 16, 64
    models = {dev: _cut_resnet(torch, dev, seed(3, device=dev))
              for dev in ("cpu", "cuda")}
    x, y = _resnet_train_batch(torch, b, hw, "cpu", seed=4)

    def make(model):
        return _fp16_guard_engine(lambda guard: _resnet_train_engine(
            torch, None, amp="float16", guard=guard, model=model)[1])
    out = _fp16_cross_device(
        torch, "fp16-resnet", f"cut ResNet float16 step at {b} x 3 x {hw} "
        f"x {hw}", models, make, [x], [y % 10],
        leaf_bar=lambda n: 1e-2 if n.startswith("fc.") else
        RESNET_CUT_LEAF_BAR, ratio_bar=RESNET_CUT_RATIO_BAR,
        kernels=("fused_conv1x1_bn_act",), updates=True)
    check(all(t.dtype == torch.float32 for m in models.values()
              for t in m.buffers()),
          "fp16-resnet: cpu check: running statistics not f32")
    return out


def phase_fp16_resnet(torch):
    """Phase fp16-resnet: resnet50 float16 AMP training through Model.fit
    under the guard (_fp16_resnet_run), eager against captured, and a cut
    step against the CPU."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import TrainGuard
    t0 = time.perf_counter()
    main = _fp16_resnet_run(torch)
    log(f"fp16-resnet: the main run done at {time.perf_counter() - t0:.1f} "
        "s into the phase")
    x, y = _resnet_train_batch(torch, 256, 224)
    pair = _graph_pair(
        torch, "fp16-resnet eager vs captured",
        lambda cap: _resnet_train_engine(
            torch, "cuda", amp="float16", capture=cap,
            guard=TrainGuard(**RESNET_F16_GUARD, scaler=GradScaler(
                **FP16_SCALER))),
        [x], [y], TRAIN_GROUPS, steps=5, linear=True,
        expect={"fused_conv1x1_bn_act": 17})
    pair.pop("engines")
    del x, y
    torch.cuda.empty_cache()
    log(f"fp16-resnet: eager vs captured done at "
        f"{time.perf_counter() - t0:.1f} s into the phase")
    cpu = _fp16_resnet_cpu(torch)
    log(f"fp16-resnet: the cpu check done at {time.perf_counter() - t0:.1f} "
        "s into the phase")
    torch.cuda.empty_cache()
    return dict(main=main, pair=pair, cpu=cpu)


def _fp16_gpt_fused_ln(torch):
    """gpt3-345M with fused_ln (#6/#7) in float16 O1 under the guard,
    captured: 3 steps at 8 x 1024 (the eager first step, the recording, a
    replay): 24 float16 nodes each of #6 and #7 in the graph, 2 x 24
    wrapper launches, every step good and finite."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import TrainGuard
    model, cfg = _fp16_gpt(torch, "cuda", fused_ln=True)
    eng = Engine(model, loss=GPTPretrainingCriterion(),
                 optimizer=AdamW(1e-4, weight_decay=0.01, fused_kernel=True),
                 amp_dtype=torch.float16,
                 guard=TrainGuard(**FP16_GUARD,
                                  scaler=GradScaler(**FP16_SCALER)))
    ids, labels = _batch(cfg, 8, 1024, "cuda")
    _zero_launches()
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = eng.train_batch([ids], [labels])[0].item()
        torch.cuda.synchronize()
        out.append((loss, eng.guard.last_outcome,
                    (time.perf_counter() - t0) * 1e3))
    launches = _read_launches()
    layers = cfg.num_hidden_layers
    recorded = _f16_nodes(torch, eng, GPT_LN_GRAPH_KERNELS
                          + GPT_GRAPH_KERNELS)
    want = {w: layers for w, _ in GPT_LN_GRAPH_KERNELS + GPT_GRAPH_KERNELS}
    want["adamw_kernel"] = 1
    check(recorded == want, f"fp16-guard: gpt fused_ln: the recorded step "
          f"holds {recorded} (float16 nodes), want {want}")
    for w, _ in GPT_LN_GRAPH_KERNELS:
        check(launches[w] == 2 * layers, f"fp16-guard: gpt fused_ln: {w} "
              f"launched {launches[w]} times, want {2 * layers} (the eager "
              "first step and the recording)")
    check(all(math.isfinite(v) and o == "ok" for v, o, _ in out),
          f"fp16-guard: gpt fused_ln: steps {out}")
    log(f"fp16-guard: gpt3-345M fused_ln, float16 O1 under the guard, "
        f"captured: (loss, outcome, ms) {out}; the graph holds {recorded} "
        f"float16 nodes")
    del model, eng
    torch.cuda.empty_cache()
    return dict(launches=launches, recorded=recorded, steps=out)


def _l2_flush(torch):
    """A write of 256 MB, which evicts the 50 MB L2 between timed
    launches."""
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    return scratch.zero_



# -- dense attention masks (phases masked-flash, ernie-finetune,
# -- transformer-mask) ------------------------------------------------------

# ERNIE-3.0-base fine-tuning as PaddleNLP's ERNIE 3.0 classification recipe
# runs it (model_zoo/ernie-3.0 run_seq_cls.py defaults): batch 32 at
# max_seq_length 128, 12 heads of 64
ERNIE_FT_B, ERNIE_FT_S = 32, 128
# the mangled names of the flash kernels' DENSE instantiations (a dense
# mask's; their first template argument, csrc/flash_attention_{fwd,bwd}.cu)
MASKED_NS = "_kernelILb1E"
FLASH_WRAPPERS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")


def _masked_launches():
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    return {n: getattr(kfa, n).masked_launches for n in FLASH_WRAPPERS}


def _zero_masked():
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    for n in FLASH_WRAPPERS:
        getattr(kfa, n).masked_launches = 0


def _test_mask(torch, kind, b, h, sq, sk, dtype, gen, device="cuda"):
    """(mask as ops.attention hands it to the kernels: a [B, H, Sq, Sk]
    view, stride 0 on its broadcast dims; causal; visible (q, k) pairs over
    every head; the mask's own bytes) of one kind:
    - "padding": ERNIE's [B, 1, 1, Sk] keep-mask, lengths from [8, Sk];
    - "subsequent": nn.Transformer's generate_square_subsequent_mask
      (f32, -inf above the diagonal);
    - "gpt": GPT's causal + padding attn_mask, padded on the left, so the
      rows before a sequence's first token see no key (NaN rows);
    - "bias": a general [B, H, Sq, Sk] additive bias in q's dtype;
    - "lowest": a [B, 1, Sq, Sk] bias in q's dtype of 0 or its lowest value
      (-3.4e38 in f32 and bf16, -65504 in float16), with causal: row 3 of
      batch 0 has every key biased, and the last batch is padded on the
      left by 6 keys, so its first 6 rows have every key biased too (a
      softmax over the biased scores, not NaN)."""
    from paddle_tpu_torch.nn.layers_transformer import Transformer
    from paddle_tpu_torch.ops.attention import _fold_mask
    cpu = torch.Generator().manual_seed(int(torch.randint(
        0, 2 ** 31 - 1, (1,), generator=gen, device=device).item()))
    lens = torch.randint(min(8, sk), sk + 1, (b,), generator=cpu)
    kpos = torch.arange(sk)
    causal = kind in ("gpt", "lowest")
    if kind == "padding":
        m = (kpos[None, :] < lens[:, None])[:, None, None, :]
    elif kind == "subsequent":
        m = Transformer.generate_square_subsequent_mask(sq)
    elif kind == "gpt":
        m = (kpos[None, :] >= (sk - lens)[:, None])[:, None, None, :]
    elif kind == "lowest":
        dt = getattr(torch, dtype)
        keep = torch.rand(b, 1, sq, sk, generator=cpu) < 0.7
        keep[..., min(12, sk - 1)] = True
        keep[0, 0, min(3, sq - 1), :] = False
        keep[-1, :, :, :6] = False
        m = torch.zeros(b, 1, sq, sk, dtype=dt).masked_fill(
            ~keep, torch.finfo(dt).min)
    else:
        m = torch.randn(b, h, sq, sk, generator=cpu).to(getattr(torch,
                                                                dtype))
    m = m.to(device)
    view = _fold_mask(m, b, h, sq, sk, device)
    vis = view.bool() if view.dtype == torch.bool else view.isfinite()
    if causal:
        qpos = torch.arange(sq, device=device)[:, None]
        vis = vis & (torch.arange(sk, device=device)[None, :]
                     <= qpos + (sk - sq))
    pairs = int(vis.sum().item())
    return view, causal, pairs, m.numel() * m.element_size()


def _same(a, b):
    """Bit for bit, NaNs included (NaN in the same places, the rest
    equal)."""
    na, nb = a.isnan(), b.isnan()
    return bool(torch_equal(na, nb)) and bool(torch_equal(a[~na], b[~nb]))


def _check_masked(tag, name, dtype, got, want):
    """got vs its twin at TOL (f32 absolute, else of max(1, |twin|)), NaN
    in the same places; the error over the rest."""
    gn, wn = got.isnan(), want.isnan()
    check(bool(torch_equal(gn, wn)), f"{tag}: {name} NaN at "
          f"{int(gn.ne(wn).sum().item())} places where its twin differs")
    if bool(wn.all()):
        return 0.0, int(gn.sum().item())
    err, scaled = _err(got[~gn], want[~wn])
    ok = err <= TOL[dtype] if dtype == "float32" else scaled <= TOL[dtype]
    check(math.isfinite(err) and ok,
          f"{tag}: {name} max_abs_err {err} (of max(1, |twin|): {scaled}) "
          f"over the {dtype} tolerance {TOL[dtype]}")
    return err, int(gn.sum().item())


def _check_lse_pair(tag, got, want):
    """A masked forward's lse pair [2, BH, Sq] (hi, lo) against its twin's:
    NaN in the same places, and the pairs' difference (hi - hi') + (lo -
    lo') in float64 within 1e-4, plus 4 f32 ulps of hi where the two hi
    differ (a biased score's rounding may move the row max by an ulp):
    where hi is the same, as on a row at -3.4e38, lo (its log l) is held
    to 1e-4 alone. Returns the largest difference."""
    gn, wn = got.isnan(), want.isnan()
    check(bool(torch_equal(gn, wn)), f"{tag}: lse NaN at "
          f"{int(gn.ne(wn).sum().item())} places where its twin differs")
    ok = ~wn.any(0)
    dh = got[0][ok].double() - want[0][ok].double()
    d = (dh + (got[1][ok].double() - want[1][ok].double())).abs()
    bar = 1e-4 + (dh != 0) * 4 * want[0][ok].double().abs() * 2.0 ** -23
    worst = float(d.max().item()) if d.numel() else 0.0
    check(bool((d <= bar).all()), f"{tag}: lse pair off its twin's by "
          f"{worst} (bar 1e-4, and 4 ulps of hi where hi differs)")
    return worst


def masked_work(b, h, sq, sk, d, esz, pairs, mask_bytes):
    """{kernel: (bytes, FLOPs)} of the masked flash kernels: flash_work's
    over this run's visible pairs, each kernel also reading the mask's own
    bytes once and lse as its pair (hi, lo)."""
    nq, nk = b * h * sq * d, b * h * sk * d
    stat = b * h * sq * 4
    return {
        "fwd": ((nq + 2 * nk + nq) * esz + 2 * stat + mask_bytes,
                4 * d * pairs),
        "dq": ((3 * nq + 2 * nk + nq) * esz + 3 * stat + mask_bytes,
               6 * d * pairs),
        "dkv": ((2 * nq + 2 * nk + 2 * nk) * esz + 3 * stat + mask_bytes,
                8 * d * pairs),
    }


def _sdpa_backend(torch, fn):
    """(backend, its largest CUDA kernel) of one SDPA call, read off a
    profile: PyTorch picks among flash, memory-efficient (cutlass fmha),
    cuDNN and the math path by the call's arguments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]
    if not rows:
        return "not measured", None
    top = max(rows, key=lambda a: a.self_device_time_total).key
    names = " ".join(a.key.lower() for a in rows)
    backend = ("cudnn" if "cudnn" in names else
               "flash" if "flash" in names else
               "efficient" if ("fmha" in names or "cutlass" in names
                               or "efficient" in names) else "math")
    return backend, top


def _masked_case(torch, b, h, sq, sk, d, dtype, kind, dropout, gen, flush,
                 timed, device="cuda"):
    """#1, #3 and #4 with a dense mask vs their twins on one input, the
    backward twins fed the kernels' own o, lse and delta; each kernel
    repeated bit for bit (NaNs in place). ``timed``: each kernel's held ms
    masked, and unmasked on the same q, k, v (the unmasked backward on its
    own forward's o and lse), the twins', and SDPA's with the same
    attn_mask (its forward; its backward for dq and for dk/dv), whose
    backend is named."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    dt = getattr(torch, dtype)
    mk = lambda s: torch.randn(b * h, s, d, generator=gen,  # noqa: E731
                               device=device).to(dt)
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    mask, causal, pairs, mask_bytes = _test_mask(torch, kind, b, h, sq, sk,
                                                 dtype, gen, device)
    seed = torch.tensor([4321], dtype=torch.int32, device=device)
    rest = (None, seed, causal, None, dropout)
    o, lse = kfa.flash_attention_fwd(q, k, v, *rest, mask=mask)
    dq, delta = kfa.flash_attention_bwd_dq(q, k, v, o, do, lse, *rest,
                                           mask=mask)
    dk, dv = kfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *rest,
                                         mask=mask)
    torch.cuda.synchronize()
    where = (f"{dtype} b{b} h{h} sq{sq} sk{sk} d{d} {kind} mask "
             f"({mask.dtype}) dropout{dropout} causal={causal}")
    tag = "masked-flash " + where
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, *rest, mask=mask)
    pdq, pdelta = kfa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse,
                                                   *rest, mask=mask)
    pdk, pdv = kfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 *rest, mask=mask)
    row = dict(dtype=dtype, b=b, h=h, sq=sq, sk=sk, d=d, kind=kind,
               mask_dtype=str(mask.dtype).replace("torch.", ""),
               dropout=dropout, causal=causal, pairs=pairs,
               mask_bytes=mask_bytes, err={}, nan={})
    for n, a, p in (("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk),
                    ("dv", dv, pdv)):
        row["err"][n], row["nan"][n] = _check_masked(tag, n, dtype, a, p)
    row["err"]["lse"] = _check_lse_pair(tag, lse, plse)
    del po, pdq, pdk, pdv
    o2, lse2 = kfa.flash_attention_fwd(q, k, v, *rest, mask=mask)
    dq2, delta2 = kfa.flash_attention_bwd_dq(q, k, v, o, do, lse, *rest,
                                             mask=mask)
    dk2, dv2 = kfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *rest,
                                           mask=mask)
    torch.cuda.synchronize()
    for n, a, a2 in (("o", o, o2), ("lse", lse, lse2), ("dq", dq, dq2),
                     ("delta", delta, delta2), ("dk", dk, dk2),
                     ("dv", dv, dv2)):
        check(_same(a, a2), f"{tag}: a second call gave another {n}")
    del o2, lse2, dq2, delta2, dk2, dv2
    if not timed:
        return row
    kw = dict(mask=mask)
    kern = {"fwd": lambda: kfa.flash_attention_fwd(q, k, v, *rest, **kw),
            "dq": lambda: kfa.flash_attention_bwd_dq(q, k, v, o, do, lse,
                                                     *rest, **kw),
            "dkv": lambda: kfa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, *rest, **kw)}
    plain = {"fwd": lambda: kfa.flash_attention_fwd_plain(q, k, v, *rest,
                                                          **kw),
             "dq": lambda: kfa.flash_attention_bwd_dq_plain(
                 q, k, v, o, do, lse, *rest, **kw),
             "dkv": lambda: kfa.flash_attention_bwd_dkv_plain(
                 q, k, v, do, lse, delta, *rest, **kw)}
    uo, ulse = kfa.flash_attention_fwd(q, k, v, *rest)
    _, udelta = kfa.flash_attention_bwd_dq(q, k, v, uo, do, ulse, *rest)
    unmasked = {"fwd": lambda: kfa.flash_attention_fwd(q, k, v, *rest),
                "dq": lambda: kfa.flash_attention_bwd_dq(
                    q, k, v, uo, do, ulse, *rest),
                "dkv": lambda: kfa.flash_attention_bwd_dkv(
                    q, k, v, do, ulse, udelta, *rest)}
    row["ms"] = {n: time_ms(torch, f, flush=flush) for n, f in kern.items()}
    row["unmasked_ms"] = {n: time_ms(torch, f, flush=flush)
                          for n, f in unmasked.items()}
    row["plain_ms"] = {n: time_ms(torch, f, flush=flush)
                       for n, f in plain.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.view(b, h, -1, d).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                           is_causal=False, dropout_p=dropout)
    if causal:  # SDPA takes no attn_mask with is_causal: fold it in
        tri = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
            sk - sq)
        cm = (mask & tri if mask.dtype == torch.bool
              else mask.masked_fill(~tri, -math.inf))
        lib_fwd = lambda: sdpa(qt, kt, vt, attn_mask=cm,  # noqa: E731
                               dropout_p=dropout)
    with torch.no_grad():
        row["library_backend"], row["library_kernel"] = _sdpa_backend(
            torch, lib_fwd)
        lib_fwd_ms = time_ms(torch, lib_fwd, flush=flush)
    out = lib_fwd()
    dout = do.view(b, h, sq, d)
    lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dout, retain_graph=True), flush=flush)
    row["library_ms"] = {"fwd": lib_fwd_ms, "dq": lib_bwd_ms,
                         "dkv": lib_bwd_ms}
    del out, qt, kt, vt
    work = masked_work(b, h, sq, sk, d, q.element_size(), pairs, mask_bytes)
    row["bound"] = {n: flash_bound(dtype, n, *w) for n, w in work.items()}
    row["flops"] = {n: w[1] for n, w in work.items()}
    return row


MASK_KINDS = ("padding", "subsequent", "gpt", "bias", "lowest")
# GPT's training shape (gpt3-345M: batch 8 x 16 heads x 1024, D = 64),
# timed causal with its causal + padding attn_mask
GPT_MASK_SHAPE = (8, 16, 1024, 64)


def phase_masked_flash(torch, flush):
    """#1, #3 and #4 with a dense mask (their DENSE instantiations)
    against their twins on the card: every mask kind in f32 (D = 32, 64,
    128, 256: the 3xTF32 forward, the 3xTF32 backward with and without its
    key split, the CUDA-core backward), bf16 and float16 (D = 64, 128; 256
    with the padding mask), ragged against the tiles, with and without
    dropout, a bias at the dtype's lowest value with rows biased whole
    among them; then ERNIE's fine-tune shape (32 x 12 x 128 x 128, D = 64,
    its padding mask, dropout 0.1) in bf16 and f32, and GPT's training
    shape causal with its causal + padding mask in bf16, each timed masked,
    unmasked, as the twins and as SDPA with the same mask."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for dtype, dims in (("float32", (32, 64, 128, 256)),
                        ("bfloat16", (64, 128)), ("float16", (64, 128))):
        for d in dims:
            for i, kind in enumerate(MASK_KINDS):
                s = 200 if d < 256 else 130
                rows.append(_masked_case(torch, 2, 2, s, s, d, dtype, kind,
                                         0.1 * (i % 2), gen, flush, False))
    for dtype in ("bfloat16", "float16"):
        rows.append(_masked_case(torch, 2, 2, 130, 130, 256, dtype,
                                 "padding", 0.1, gen, flush, False))
    # few query rows (the f32 dq's key split) over more keys: DETR's
    # decoder cross attention's shape with a padding mask
    rows.append(_masked_case(torch, 1, 2, 100, 300, 32, "float32",
                             "padding", 0.0, gen, flush, False))
    nan_rows = [r for r in rows if r["nan"]["o"]]
    check(nan_rows, "masked-flash: no case had a row with no visible key")
    timed = {}
    for dtype in ("bfloat16", "float32"):
        r = _masked_case(torch, ERNIE_FT_B, 12, ERNIE_FT_S, ERNIE_FT_S, 64,
                         dtype, "padding", 0.1, gen, flush, True)
        rows.append(r)
        timed[dtype] = r
    # a causal masked call: the dk/dv kernels skip the query tiles the
    # causal mask hides from their keys, as unmasked
    gb, gh, gs, gd = GPT_MASK_SHAPE
    r = _masked_case(torch, gb, gh, gs, gs, gd, "bfloat16", "gpt", 0.0, gen,
                     flush, True)
    rows.append(r)
    timed["bfloat16 causal"] = r
    for r in rows:
        log(f"masked-flash: {r['dtype']} b{r['b']} h{r['h']} sq{r['sq']} "
            f"sk{r['sk']} d{r['d']} {r['kind']} ({r['mask_dtype']}) dropout"
            f" {r['dropout']} causal={r['causal']}: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, e in r["err"].items())
            + f"; NaN o/dq/dk/dv {r['nan']['o']}/{r['nan']['dq']}/"
            f"{r['nan']['dk']}/{r['nan']['dv']} (as the twin)")
    for dtype, r in timed.items():
        where = ("GPT's shape, causal + left padding" if "causal" in dtype
                 else "ERNIE fine-tune shape")
        bwd, ubwd = (r["ms"]["dq"] + r["ms"]["dkv"],
                     r["unmasked_ms"]["dq"] + r["unmasked_ms"]["dkv"])
        log(f"masked-flash: {where} {dtype} backward (#3 + #4): held "
            f"{bwd:.4f} ms, unmasked {ubwd:.4f}, SDPA's whole backward with "
            f"the mask {r['library_ms']['dq']:.4f} "
            f"({r['library_ms']['dq'] / bwd:.2f}x the kernels' time)")
        for n in ("fwd", "dq", "dkv"):
            bms, by = r["bound"][n]
            log(f"masked-flash: {where} {dtype} {n}: held "
                f"{r['ms'][n]:.4f} ms (unheld {unheld(r['ms'][n]):.4f}), "
                f"unmasked {r['unmasked_ms'][n]:.4f}, twin "
                f"{r['plain_ms'][n]:.4f}, SDPA with the mask "
                f"{r['library_ms'][n]:.4f} ({r['library_backend']}: "
                f"{r['library_kernel']}), bound {bms:.4f} ms ({by}; "
                f"{r['pairs']} visible pairs, mask {r['mask_bytes']} "
                "bytes)")
    return dict(rows=rows, timed=timed)


# the fine-tune's tokens: ids uniform in [1, FT_TOKENS), the vocabulary
# examples/finetune_bert.py draws from, whose label (token 7 in the
# sequence) then marks about 1 in 15; 0 is the padding
FT_TOKENS = 1000
FT_TRAIN, FT_EVAL, FT_F32_STEPS = 2048, 512, 16
# the masked kernels a captured ERNIE step holds, by the dtype it runs in:
# (wrapper, kernel name fragment) as _graph_node_names reads them
FT_GRAPH_KERNELS = {
    "bfloat16": (("flash_attention_fwd", "flash_fwd_tc_kernel"),
                 ("flash_attention_bwd_dq", "flash_bwd_dq_tc_kernel"),
                 ("flash_attention_bwd_dkv", "flash_bwd_dkv_tc_kernel")),
    "float32": (("flash_attention_fwd", "flash_fwd_f32_kernel"),
                ("flash_attention_bwd_dq", "flash_bwd_dq_f32_kernel"),
                ("flash_attention_bwd_dkv", "flash_bwd_dkv_f32_kernel")),
}


def _ft_sets(s):
    """(train, eval) sequence-classification sets from numpy seed 0, each
    (input_ids, token_type_ids, attention_mask, labels [n, 1]) int64:
    lengths uniform in [8, s], right padding with pad_token_id 0, the
    tokenizer's 0/1 mask, label 1 where token 7 is in the unpadded
    part."""
    import numpy as np
    rng = np.random.default_rng(0)

    def make(n):
        lens = rng.integers(8, s + 1, n)
        keep = np.arange(s)[None, :] < lens[:, None]
        ids = np.where(keep, rng.integers(1, FT_TOKENS, (n, s)), 0)
        labels = ((ids == 7) & keep).any(axis=1)
        return (ids.astype(np.int64), np.zeros((n, s), np.int64),
                keep.astype(np.int64), labels.astype(np.int64)[:, None])
    return make(FT_TRAIN), make(FT_EVAL)


def _ft_dataset(arrays, n=None):
    """An io.Dataset over the first ``n`` samples of ``arrays``."""
    from paddle_tpu_torch.io import Dataset
    n = len(arrays[0]) if n is None else n

    class _Seqs(Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return tuple(a[i] for a in arrays)
    return _Seqs()


def _ft_model(net, amp):
    """paddle.Model over ``net`` with three input specs and one label,
    prepared as the fine-tune runs: AdamW(3e-5, weight_decay=0.01,
    fused_kernel=True), cross entropy, accuracy."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import InputSpec
    s = ERNIE_FT_S
    specs = [InputSpec([None, s], "int64", n) for n in
             ("input_ids", "token_type_ids", "attention_mask")]
    m = Model(net, inputs=specs,
              labels=[InputSpec([None, 1], "int64", "label")])
    m.prepare(AdamW(3e-5, weight_decay=0.01, fused_kernel=True),
              CrossEntropyLoss(), Accuracy(), amp_configs=amp)
    return m


def _ft_fit(torch, tag, net, dtype, amp, data, steps):
    """One epoch of Model.fit over ``steps`` batches: ms a step (the
    median batch-end to batch-end time of steps 8..end), sequences/s, a
    profiled step's busy share, peak memory, every flash launch masked
    (24 of each: the eager first step and the recording), the recorded
    step holding 12 masked nodes of each flash kernel and no unmasked one,
    no plain twin called, the fused AdamW in the graph."""
    b = ERNIE_FT_B
    m = _ft_model(net, amp)
    probe = _FitProbe(torch, profile_after=min(40, steps - 3))
    _zero_launches()
    _zero_masked()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _TwinWatch() as twins:
        m.fit(_ft_dataset(data, steps * b), batch_size=b, epochs=1,
              shuffle=False, verbose=0, callbacks=[probe.callback])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not twins.calls, f"{tag}: plain twins ran on the card: "
          f"{twins.calls}")
    launches, masked = _read_launches(), _masked_launches()
    layers = net.config.num_hidden_layers
    for w in FLASH_WRAPPERS:
        check(masked[w] == launches[w] == 2 * layers,
              f"{tag}: {w} launched {launches[w]} times, {masked[w]} of them"
              f" masked, over {steps} captured steps; want {2 * layers} "
              "(the eager first step and the recording), every one masked")
    nodes = _graph_node_names(torch, _recording(m._engine, "train").graph)
    per_step = {w: sum(frag in n and MASKED_NS in n for n in nodes)
                for w, frag in FT_GRAPH_KERNELS[dtype]}
    plain_flash = sum(("flash_fwd" in n or "flash_bwd" in n)
                      and MASKED_NS not in n for n in nodes)
    adamw = sum("adamw_kernel" in n for n in nodes)
    check(all(v == layers for v in per_step.values()) and not plain_flash
          and adamw == 1,
          f"{tag}: the recorded step holds masked flash nodes {per_step}, "
          f"{plain_flash} unmasked ones and {adamw} AdamW; want {layers} "
          "each, 0 and 1")
    losses = probe.losses
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{tag}: losses {losses}")
    gaps = sorted((probe.ends[i] - probe.ends[i - 1]) * 1e3
                  for i in range(8, steps))
    ms = gaps[len(gaps) // 2]
    busy = probe.busy(tag)
    log(f"{tag}: Model.fit, {steps} steps of {b} x {ERNIE_FT_S} in {wall:.2f}"
        f" s ({dtype}); median {ms:.3f} ms a step = {b / ms * 1e3:.1f} "
        f"sequences/s (batch end to batch end, steps 8..{steps - 1}, the "
        f"profiled one among them); busy share "
        f"{busy.get('busy_share')}; peak {peak_gb:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; masked launches {masked}, a "
        f"replayed step {per_step} masked nodes")
    return m, dict(ms_per_step=ms, seq_s=b / ms * 1e3, wall_s=wall,
                   peak_gb=peak_gb, losses=losses, launches=launches,
                   masked_launches=masked, per_step=per_step, **busy)


def phase_ernie_finetune(torch):
    """ERNIE-3.0-base-zh fine-tuning for sequence classification through
    paddle.Model, as PaddleNLP's ERNIE 3.0 recipe shapes it: 2048 padded
    sequences at batch 32 x 128 (weights from seed 0, dropout 0.1, the
    default config: fused_ln off), one epoch in bf16 AMP O1 with
    AdamW(fused_kernel=True), the step captured as one CUDA graph; then
    evaluate and predict over 512 sequences (f32, eager); then 16 steps in
    f32; then the card's f32 evaluate against the CPU's on the same
    weights over 2 eval batches. Every attention call takes the padding
    mask through the masked kernels (#1, #3, #4), none a plain path."""
    import numpy as np
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.ernie import (ErnieForSequenceClassification,
                                            _resolve_config)
    b, s = ERNIE_FT_B, ERNIE_FT_S
    train, evl = _ft_sets(s)
    cfg = _resolve_config("ernie-3.0-base-zh", num_labels=2)
    t0 = time.perf_counter()
    net = ErnieForSequenceClassification(cfg, device="cuda",
                                         generator=seed(0, device="cuda"))
    torch.cuda.synchronize()
    log(f"ernie-finetune: ernie-3.0-base-zh sequence classifier built on "
        f"cuda in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in net.parameters())} parameters, "
        f"{len(net.state_dict())} state-dict keys, {cfg.num_hidden_layers} "
        f"layers, dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}); {FT_TRAIN} train / {FT_EVAL} "
        f"eval sequences, lengths 8..{s}, {float(train[3].mean()):.3f} "
        "labelled 1")
    out = {}
    m, out["bfloat16"] = _ft_fit(torch, "ernie-finetune bf16", net,
                                 "bfloat16", {"level": "O1",
                                              "dtype": "bfloat16"},
                                 train, FT_TRAIN // b)
    losses = out["bfloat16"]["losses"]
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < first, f"ernie-finetune: the bf16 loss did not fall: "
          f"{first:.4f} over the first 8 steps, {last:.4f} over the last 8")
    for what, run in (("evaluate", lambda: m.evaluate(
            _ft_dataset(evl), batch_size=b, verbose=0)),
                      ("predict", lambda: m.predict(
                          _ft_dataset(evl), batch_size=b,
                          stack_outputs=True, verbose=0))):
        _zero_launches()
        _zero_masked()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        masked = _masked_launches()
        want = cfg.num_hidden_layers * FT_EVAL // b
        check(masked["flash_attention_fwd"] == want
              == _read_launches()["flash_attention_fwd"]
              and not masked["flash_attention_bwd_dq"],
              f"ernie-finetune: {what} launched {masked} masked kernels, "
              f"want {want} masked forwards (12 a batch), no backward")
        if what == "predict":
            check(res[0].shape == (FT_EVAL, 2)
                  and bool(np.isfinite(res[0]).all()),
                  f"ernie-finetune: predict gave {res[0].shape}")
            res = {"logits_shape": list(res[0].shape)}
        out[what] = dict(res, seconds=secs, masked_launches=masked,
                         seq_s=FT_EVAL / secs)
        log(f"ernie-finetune: {what} over {FT_EVAL} sequences (f32, eager) "
            f"in {secs:.3f} s = {FT_EVAL / secs:.1f} sequences/s: {res}; "
            f"masked launches {masked}")
    _, out["float32"] = _ft_fit(torch, "ernie-finetune f32", net, "float32",
                                None, train, FT_F32_STEPS)
    out["cpu"] = _ft_cpu_check(torch, net, evl)
    return out


def _ft_cpu_check(torch, net, evl):
    """The card's f32 evaluate and predict against the CPU's on the same
    weights, 2 eval batches: the loss at 1e-3 relative, the logits at
    1e-3 of their max-abs, the same accuracy."""
    import numpy as np
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.ernie import ErnieForSequenceClassification
    b = ERNIE_FT_B
    cpu = ErnieForSequenceClassification(net.config, device="cpu",
                                         generator=seed(0, device="cpu"))
    cpu.load_state_dict({k: v.detach().cpu() for k, v in
                         net.state_dict().items()})
    res = {}
    for dev, model in (("cuda", net), ("cpu", cpu)):
        m = _ft_model(model, None)
        _zero_masked()
        t0 = time.perf_counter()
        ev = m.evaluate(_ft_dataset(evl, 2 * b), batch_size=b, verbose=0)
        logits = m.predict(_ft_dataset(evl, 2 * b), batch_size=b,
                           stack_outputs=True, verbose=0)[0]
        res[dev] = dict(ev, logits=logits, masked=_masked_launches(),
                        seconds=time.perf_counter() - t0)
    g, c = res["cuda"], res["cpu"]
    layers = net.config.num_hidden_layers
    check(g["masked"]["flash_attention_fwd"] == 4 * layers
          and not c["masked"]["flash_attention_fwd"],
          f"ernie-finetune cpu: masked forwards {g['masked']} on the card, "
          f"{c['masked']} on the CPU; want {4 * layers} and none")
    scale = float(np.abs(c["logits"]).max())
    err = float(np.abs(g["logits"] - c["logits"]).max())
    rel = abs(g["loss"][0] - c["loss"][0]) / abs(c["loss"][0])
    check(err <= 1e-3 * scale and rel <= 1e-3 and g["acc"] == c["acc"],
          f"ernie-finetune cpu: logits {err} (max-abs {scale}), loss "
          f"{g['loss']} vs {c['loss']}, acc {g['acc']} vs {c['acc']}")
    log(f"ernie-finetune cpu: f32 evaluate of 2 batches, card vs CPU on the "
        f"same weights: loss {g['loss'][0]:.6f} vs {c['loss'][0]:.6f} "
        f"({rel:.2e} relative), logits max_abs_err {err:.3e} of max-abs "
        f"{scale:.3f}, acc {g['acc']} both; CPU {c['seconds']:.1f} s")
    return dict(logits_err=err, logits_scale=scale, loss_rel=rel)


def phase_transformer_mask(torch):
    """nn.Transformer (d_model 512, 8 heads, 6 + 6 layers, f32, dropout 0,
    GELU) with a padding src_mask and memory_mask ([B, 1, 1, S_src] bool)
    and generate_square_subsequent_mask as tgt_mask: one forward and
    backward on the card, every attention through the masked kernels (18
    launches of each), held with the CPU's f32 run against a float64 run
    on the CPU, same weights: the card's output and each gradient within
    1e-3 of its max-abs from float64, or no further than twice the CPU's
    f32. The feed-forward blocks run GELU, not the default ReLU: a ReLU
    whose input lies within rounding of 0 flips between two f32 runs and
    moves its linear1's gradient by 2e-2 and every gradient below it by
    1e-3 (measured on the card: decoder layer 3's, with the kernels 1e-7
    from the twins), which says nothing of the attention. A gradient that
    is 0 in exact arithmetic (each attention's k_proj.bias: a softmax row
    is blind to a shift of all its scores) is rounding on every run: it is
    held to 1e-6 of the largest gradient on the card, and a max-abs below
    1e-4 of the largest gradient's counts as rounding elsewhere."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nn.layers_transformer import Transformer
    b, s_src, s_tgt, d = 8, 64, 48, 512
    cpu = torch.Generator().manual_seed(21)
    src = torch.randn(b, s_src, d, generator=cpu)
    tgt = torch.randn(b, s_tgt, d, generator=cpu)
    w = torch.randn(b, s_tgt, d, generator=cpu)
    lens = torch.randint(16, s_src + 1, (b,), generator=cpu)
    pad = (torch.arange(s_src)[None, :] < lens[:, None])[:, None, None, :]
    sub = Transformer.generate_square_subsequent_mask(s_tgt)
    gm = Transformer(d, 8, dropout=0.0, activation="gelu", device="cuda",
                     generator=seed(3, device="cuda"))
    state = {k: v.cpu() for k, v in gm.state_dict().items()}
    res = {}
    for tag, dev, dt, m in (
            ("cuda", "cuda", torch.float32, gm),
            ("cpu", "cpu", torch.float32, None),
            ("float64", "cpu", torch.float64, None)):
        if m is None:
            m = Transformer(d, 8, dropout=0.0, activation="gelu",
                            device="cpu", generator=seed(3, device="cpu"))
            m.load_state_dict(state)
            m = m.to(dt)
        _zero_launches()
        _zero_masked()
        t = [x.to(dev) for x in (src, tgt, w, pad, sub)]
        t = [x.to(dt) if x.is_floating_point() else x for x in t]
        out = m(t[0], t[1], src_mask=t[3], tgt_mask=t[4], memory_mask=t[3])
        (out * t[2]).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        res[tag] = dict(masked=_masked_launches(), launches=_read_launches(),
                        vals={"out": out.detach().cpu().double(), **{
                            n: p.grad.detach().cpu().double()
                            for n, p in m.named_parameters()}})
    g, c, f = res["cuda"], res["cpu"], res["float64"]
    want = 18  # 6 encoder self-attentions, 6 decoder self, 6 cross
    for n in FLASH_WRAPPERS:
        check(g["masked"][n] == g["launches"][n] == want
              and not c["masked"][n],
              f"transformer-mask: {n} launched {g['launches'][n]} times, "
              f"{g['masked'][n]} masked, on the card; want {want}, all "
              "masked")
    top = max(v.abs().max().item() for k, v in f["vals"].items()
              if k != "out")
    worst = {}
    for name, ref in f["vals"].items():
        if name.endswith("k_proj.bias"):
            # 0 in exact arithmetic: rounding on every run, held by its
            # size against the largest gradient, not against another run's
            # rounding
            e_card = g["vals"][name].abs().max().item() / top
            e_cpu = c["vals"][name].abs().max().item() / top
            check(math.isfinite(e_card) and e_card <= 1e-6,
                  f"transformer-mask: {name} (0 in exact arithmetic) "
                  f"{e_card:.3e} of the largest gradient on the card, "
                  f"{e_cpu:.3e} on the CPU")
            worst[name] = (e_card, e_cpu)
            continue
        scale = max(ref.abs().max().item(),
                    1e-30 if name == "out" else 1e-4 * top)
        e_card = (g["vals"][name] - ref).abs().max().item() / scale
        e_cpu = (c["vals"][name] - ref).abs().max().item() / scale
        check(math.isfinite(e_card) and e_card <= max(2 * e_cpu, 1e-3),
              f"transformer-mask: {name} from float64 {e_card:.3e} of its "
              f"max-abs on the card, {e_cpu:.3e} on the CPU")
        worst[name] = (e_card, e_cpu)
    order = sorted((k for k in worst if not k.endswith("k_proj.bias")),
                   key=lambda k: -worst[k][0])
    kb = max(worst[k][0] for k in worst if k.endswith("k_proj.bias"))
    log(f"transformer-mask: nn.Transformer(512, 8, GELU), batch {b}, src "
        f"{s_src}"
        f" (padding mask, lengths {lens.tolist()}), tgt {s_tgt} "
        f"(generate_square_subsequent_mask), f32 card and CPU from a "
        f"float64 CPU run, of each max-abs: output {worst['out'][0]:.2e} "
        f"(CPU {worst['out'][1]:.2e}); the largest of {len(worst) - 1} "
        "gradients " + ", ".join(
            f"{k} {worst[k][0]:.2e} (CPU {worst[k][1]:.2e})"
            for k in order[:3]) + f"; k_proj.bias (0 in exact arithmetic) "
        f"at most {kb:.2e} of the largest gradient; masked launches "
        f"{g['masked']}")
    return dict(worst=worst, masked=g["masked"])


def _jsonable(x):
    """``x`` with every dict key a string and every tuple a list."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def main():
    """Every phase, then the kernel table and the result line; with
    ``--compare-bwd SRC...``, ``--compare-fwd SRC...``,
    ``--compare-decode SRC...``, ``--compare-paged SRC...``,
    ``--compare-ln SRC...`` or ``--compare-conv SRC...``, only that
    comparison; with ``--compare-steps TREE...``, the training paths'
    steps (``steps_of``) with each tree's package in turn; with
    ``--adamw-geometry``, #10 built at other launch geometries
    (``adamw_geometry``)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    steps_tree = sys.argv[2] if sys.argv[1:2] == ["--steps-of"] else None
    root = os.path.abspath(steps_tree or HERE)
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch", "csrc")):
        print(f"chip_smoke: paddle_tpu_torch/ not found in {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if steps_tree:
        print(json.dumps(steps_of(torch)), flush=True)
        return 0
    alone = {"--train-graph": phase_train_graph,
             "--zoo-serve": phase_zoo_serve, "--zoo-train": phase_zoo_train,
             "--vision-ops": phase_vision_ops,
             "--fp16-guard": lambda t: phase_fp16_guard(t, _l2_flush(t)),
             "--fp16-kernels": lambda t: phase_fp16_kernels(t, _l2_flush(t)),
             "--fp16-ernie": phase_fp16_ernie,
             "--fp16-resnet": phase_fp16_resnet,
             "--llama-serve": lambda t: dict(
                 serve=phase_llama_serve(t), cpu=phase_llama_serve_cpu(t)),
             "--fp16-decode": lambda t: dict(
                 kernels=phase_fp16_decode(t, _l2_flush(t)),
                 generate=phase_generate_fp16(t)),
             "--masked-flash": lambda t: phase_masked_flash(
                 t, _l2_flush(t))["timed"],
             "--ernie-finetune": lambda t: dict(
                 finetune=phase_ernie_finetune(t),
                 transformer=phase_transformer_mask(t))}
    if sys.argv[1:2] and sys.argv[1] in alone:
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
        from paddle_tpu_torch.ops import _build
        _build.build_all()
        print(json.dumps(_jsonable(alone[sys.argv[1]](torch))), flush=True)
        return 0
    if sys.argv[1:2] == ["--adamw-geometry"]:
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
        adamw_geometry(torch)
        return 0
    if sys.argv[1:2] == ["--compare-steps"]:
        check(len(sys.argv) > 2, "--compare-steps needs package trees")
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
        compare_steps(torch, sys.argv[2:])
        return 0
    modes = {"--compare-bwd": compare_bwd, "--compare-fwd": compare_fwd,
             "--compare-decode": compare_decode,
             "--compare-paged": compare_paged, "--compare-ln": compare_ln,
             "--compare-conv": compare_conv}
    if sys.argv[1:2] and sys.argv[1] in modes:
        check(len(sys.argv) > 2, f"{sys.argv[1]} needs source files")
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip())
        modes[sys.argv[1]](torch, sys.argv[2:])
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")

    t_start = time.perf_counter()

    def stamp(name):
        log(f"time: {name} done at {time.perf_counter() - t_start:.1f} s")

    phase_build()
    stamp("build")
    # a 256 MB write between timed launches evicts the 50 MB L2, as the
    # model's weight reads do between a layer's attention calls
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    flash = phase_flash(torch, flush)
    stamp("flash")
    decode = phase_decode(torch, flush)
    stamp("decode")
    ftrain = phase_flash_train(torch, flush)
    stamp("flash_train")
    adamw = phase_adamw(torch, flush)
    stamp("adamw")
    fln = phase_fused_ln(torch, flush)
    stamp("fused_ln")
    noncausal = phase_flash_noncausal(torch, flush)
    stamp("flash_noncausal")
    d32 = phase_flash_d32(torch, flush)
    stamp("flash_d32")
    lflash = phase_llama_flash(torch, flush)
    stamp("llama_flash")
    mflash = phase_masked_flash(torch, flush)
    stamp("masked_flash")
    ddec = phase_dense_decode(torch, flush)
    stamp("dense_decode")
    f16dec = phase_fp16_decode(torch, flush)
    stamp("fp16_decode")
    conv = phase_conv_bn_act(torch, flush)
    stamp("conv_bn_act")
    del scratch
    sl = phase_slice(torch)
    stamp("slice")
    tr = phase_train(torch)
    stamp("train")
    phase_train_cpu(torch)
    stamp("train_cpu")
    torch.cuda.empty_cache()
    er = phase_ernie(torch)
    stamp("ernie")
    torch.cuda.empty_cache()
    gf = phase_gpt_fused_ln(torch)
    stamp("gpt_fused_ln")
    torch.cuda.empty_cache()
    phase_ernie_cpu(torch)
    stamp("ernie_cpu")
    torch.cuda.empty_cache()
    g13 = phase_gpt13b(torch)
    stamp("gpt_1_3b")
    phase_gpt13b_cpu(torch)
    stamp("gpt_1_3b_cpu")
    torch.cuda.empty_cache()
    g13o = phase_gpt13b_options(torch)
    stamp("gpt_1_3b_options")
    phase_recompute_dropout(torch)
    stamp("recompute_dropout")
    lt = phase_llama_train(torch)
    stamp("llama_train")
    phase_llama_train_cpu(torch)
    stamp("llama_train_cpu")
    torch.cuda.empty_cache()
    gg = phase_generate_gpt(torch)
    stamp("generate_gpt")
    torch.cuda.empty_cache()
    gl = phase_generate_llama(torch)
    stamp("generate_llama")
    torch.cuda.empty_cache()
    gf16 = phase_generate_fp16(torch)
    stamp("generate_fp16")
    torch.cuda.empty_cache()
    phase_generate_llama_gqa(torch)
    stamp("generate_llama_gqa")
    torch.cuda.empty_cache()
    phase_generate_cpu(torch)
    stamp("generate_cpu")
    torch.cuda.empty_cache()
    lsv = phase_llama_serve(torch)
    stamp("llama_serve")
    torch.cuda.empty_cache()
    phase_llama_serve_cpu(torch)
    stamp("llama_serve_cpu")
    torch.cuda.empty_cache()
    rs = phase_resnet_serve(torch)
    stamp("resnet_serve")
    torch.cuda.empty_cache()
    phase_resnet_cpu(torch)
    stamp("resnet_cpu")
    torch.cuda.empty_cache()
    rt = phase_resnet_train(torch)
    stamp("resnet_train")
    phase_resnet_train_cpu(torch)
    stamp("resnet_train_cpu")
    torch.cuda.empty_cache()
    fr = phase_fit_resnet50(torch, rt["fused"])
    stamp("fit_resnet50")
    fl = phase_fit_lenet(torch)
    stamp("fit_lenet")
    torch.cuda.empty_cache()
    dt = phase_detr_serve(torch)
    stamp("detr_serve")
    phase_detr_cpu(torch, dt.pop("model"))
    stamp("detr_cpu")
    torch.cuda.empty_cache()
    py = phase_ppyoloe_serve(torch)
    stamp("ppyoloe_serve")
    phase_ppyoloe_cpu(torch, py.pop("state"))
    stamp("ppyoloe_cpu")
    torch.cuda.empty_cache()
    dtr = phase_detr_train(torch)
    stamp("detr_train")
    phase_detr_train_cpu(torch)
    stamp("detr_train_cpu")
    torch.cuda.empty_cache()
    phase_ppyoloe_train(torch)
    stamp("ppyoloe_train")
    phase_ppyoloe_train_cpu(torch)
    stamp("ppyoloe_train_cpu")
    torch.cuda.empty_cache()
    tg = phase_train_graph(torch)
    stamp("train_graph")
    torch.cuda.empty_cache()
    fg = phase_fp16_guard(torch, _l2_flush(torch))
    stamp("fp16_guard")
    torch.cuda.empty_cache()
    fk = phase_fp16_kernels(torch, _l2_flush(torch))
    stamp("fp16_kernels")
    torch.cuda.empty_cache()
    fe = phase_fp16_ernie(torch)
    stamp("fp16_ernie")
    torch.cuda.empty_cache()
    fres = phase_fp16_resnet(torch)
    stamp("fp16_resnet")
    torch.cuda.empty_cache()
    phase_zoo_serve(torch)
    stamp("zoo_serve")
    zt = phase_zoo_train(torch)
    stamp("zoo_train")
    phase_vision_ops(torch)
    stamp("vision_ops")
    torch.cuda.empty_cache()
    eft = phase_ernie_finetune(torch)
    stamp("ernie_finetune")
    torch.cuda.empty_cache()
    phase_transformer_mask(torch)
    stamp("transformer_mask")

    dmain = next(r for r in decode if r["dtype"] == "float32"
                 and r["b"] == 8 and r["g"] == 1 and "ms" in r)
    # #1, #3, #4 at the training shape with dropout, bf16 as the slice
    # runs it
    fmain = next(r for r in ftrain if "ms" in r and r["dtype"] == "bfloat16"
                 and r["dropout"] and r["d"] == 64)
    # ... and at GPT-1.3B's (B=4, H=16, S=1024, D=128)
    f13 = next(r for r in ftrain if "ms" in r and r["d"] == 128)

    def adamw_row(path, case, launches):
        """#10's row on one path: the multi-leaf launch over that path's
        leaf set (timed in phase adamw or the path's phase), its
        launches over the path's run."""
        return dict(
            name="fused_adamw_multi_update", path=path,
            shape=f"{case['leaves']} leaves, {case['values']} values",
            route="cuda", source="paddle_tpu_torch/csrc/fused_adamw.cu",
            replaces="paddle_tpu/ops/pallas/fused_adamw.py:68",
            launches=launches,
            launches_per_step=case["launches_per_step"],
            max_abs_err=case["max_abs_err"], ms=case["ms"],
            plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"], library_ms=case["library_ms"],
            parent_route_ms=case["parent_route_ms"],
            route_ms=case["route_ms"])

    def flash_row(name, part, timing, source, replaces, errs=(),
                  dtype="float32", fm=fmain, path=tr):
        bms, by = fm["bound"][timing]
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path["launches"][name],
            max_abs_err=max([r["err"][part] for r in ftrain + noncausal
                             if r["dtype"] == dtype] + list(errs)),
            ms=fm["ms"][timing], plain_ms=fm["plain_ms"][timing],
            bound_ms=bms, bound_by=by,
            library_ms=fm["library_ms"][timing])

    fwd_src = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
    fwd_tpu = "paddle_tpu/ops/pallas/flash_attention.py:309"
    bwd_src = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
    # #1 in f32: the serving slice's prefill (phase 2's S=1024 case)
    fprefill = next(r for r in flash if "ms" in r and r["sq"] == 1024)
    kernels = [
        dict(flash_row("flash_attention_fwd", "o", "fwd", fwd_src, fwd_tpu,
                       [r["max_abs_err"] for r in flash
                        if r["dtype"] == "bfloat16"], dtype="bfloat16"),
             dtype="bfloat16"),
        dict(name="flash_attention_fwd", dtype="float32", route="cuda",
             source=fwd_src, replaces=fwd_tpu,
             launches=sl["launches"]["flash_attention_fwd"],
             max_abs_err=max([r["err"]["o"] for r in ftrain + noncausal
                              if r["dtype"] == "float32"]
                             + [r["max_abs_err"] for r in flash
                                if r["dtype"] == "float32"]),
             ms=fprefill["ms"], plain_ms=fprefill["plain_ms"],
             bound_ms=fprefill["bound_ms"], bound_by=fprefill["bound_by"],
             library_ms=fprefill["library_ms"]),
        flash_row("flash_attention_bwd_dq", "dq", "dq", bwd_src,
                  "paddle_tpu/ops/pallas/flash_attention.py:365"),
        flash_row("flash_attention_bwd_dkv", "dk", "dkv", bwd_src,
                  "paddle_tpu/ops/pallas/flash_attention.py:385"),
        dict(name="paged_flash_decode", route="cuda",
             source="paddle_tpu_torch/csrc/paged_flash_decode.cu",
             replaces="paddle_tpu/ops/pallas/flash_decode.py:99",
             launches=sl["launches"]["paged_flash_decode"],
             max_abs_err=max(r["max_abs_err"] for r in decode
                             if r["dtype"] == "float32"),
             ms=dmain["ms"], plain_ms=dmain["plain_ms"],
             bound_ms=dmain["bound_ms"], bound_by=dmain["bound_by"],
             library_ms=None),
        adamw_row("train", adamw["multi"][("gpt3-345M", False)],
                  tr["launches"]["fused_adamw_multi_update"]),
        adamw_row("ernie", er["adamw"],
                  er["launches"]["fused_adamw_multi_update"]),
    ]

    def ln_row(name, part, replaces, shape, path):
        tm = fln["timing"][shape]
        bms, by = tm["bound"][name]
        return dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/fused_ln.cu",
            replaces=replaces, launches=path["launches"][name],
            max_abs_err=max(r["err"][part] for r in fln["rows"]
                            if r["dtype"] == "float32"),
            ms=tm["ms"][name], plain_ms=tm["plain_ms"][name], bound_ms=bms,
            # the backwards beside PyTorch's own LayerNorm backward, which
            # reads one row tensor fewer than #9 and lacks #7's + ds; no
            # single call adds and normalises (#6, #8)
            bound_by=by, library_ms=tm["native_bwd_ms"] if "bwd" in name
            else None)

    # #2 at the greedy generate shapes, every row at 576 keys (the last
    # step): GPT's f32 cache and Llama-2-7B's bf16 one
    for dtype, d, path in (("float32", 64, gg["float32"]),
                           ("bfloat16", 128, gl)):
        dd = next(r for r in ddec if "ms" in r and r["d"] == d)
        kernels.append(dict(
            name="flash_decode", dtype=dtype, route="cuda",
            source="paddle_tpu_torch/csrc/flash_decode.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:485",
            launches=path["launches"]["flash_decode"],
            max_abs_err=max(r["max_abs_err"] for r in ddec
                            if r["dtype"] == dtype),
            ms=dd["ms"], plain_ms=dd["plain_ms"], bound_ms=dd["bound_ms"],
            bound_by=dd["bound_by"], library_ms=dd["library_ms"]))

    # #2 with a float16 cache (phase fp16-decode, timed at llama2-7b's
    # shape, GPT's beside), launched by generate-fp16's llama2-7b
    d16 = next(r for r in f16dec["dense"] if "ms" in r and r["d"] == 128)
    d16_gpt = next(r for r in f16dec["dense"] if "ms" in r and r["d"] == 64)
    kernels.append(dict(
        name="flash_decode", dtype="float16", shape="4x32x576x128",
        path="generate-fp16", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:485",
        launches=gf16["launches"]["flash_decode"],
        max_abs_err=max(r["max_abs_err"] for r in f16dec["dense"]),
        ms=d16["ms"], plain_ms=d16["plain_ms"], bound_ms=d16["bound_ms"],
        bound_by=d16["bound_by"], library_ms=d16["library_ms"],
        gpt_shape={k: d16_gpt[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "library_ms")}))
    # #5 on the Llama serving path (phase llama-serve): at llama-1b's batch
    # 32 shape (phase fp16-decode), f32 q over f32 pools for the f32
    # model's rungs, float16 q over f32 pools for the float16 model's
    # (its other pools' held ms beside)
    p32 = next(r for r in f16dec["paged"] if "ms" in r
               and r["q_dtype"] == "float32")
    p16 = {r["dtype"]: r for r in f16dec["paged"] if "ms" in r
           and r["q_dtype"] == "float16"}
    llama_shape = "32x4x4x128 ps128 mp2"
    for dtype, case, launches, errs in (
            ("float32", p32, lsv["launches"]["paged_flash_decode"],
             [p32["max_abs_err"]]),
            ("float16", p16["float32"],
             lsv["f16_launches"]["paged_flash_decode"],
             [r["max_abs_err"] for r in f16dec["paged"]
              if r["q_dtype"] == "float16"])):
        row = dict(
            name="paged_flash_decode", dtype=dtype, shape=llama_shape,
            path="llama-serve", route="cuda",
            source="paddle_tpu_torch/csrc/paged_flash_decode.cu",
            replaces="paddle_tpu/ops/pallas/flash_decode.py:99",
            launches=launches, max_abs_err=max(errs), ms=case["ms"],
            plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"], library_ms=None)
        if dtype == "float16":
            row["pools_ms"] = {k: r["ms"] for k, r in p16.items()}
            row["pools_bound_ms"] = {k: r["bound_ms"] for k, r in p16.items()}
        kernels.append(row)

    ln_src = "paddle_tpu/ops/pallas/fused_ln.py"
    kernels += [
        ln_row("fused_add_layer_norm_fwd", "fwd", f"{ln_src}:134", "gpt", gf),
        ln_row("fused_add_layer_norm_bwd", "bwd", f"{ln_src}:165", "gpt", gf),
        ln_row("fused_add_layer_norm_y_fwd", "y_fwd", f"{ln_src}:267",
               "ernie", er),
        ln_row("fused_add_layer_norm_y_bwd", "y_bwd", f"{ln_src}:294",
               "ernie", er),
    ]
    # GPT-1.3B's training path (phase gpt-1.3b): #1, #3, #4 at its
    # attention shape, #6/#7 at its 4096 x 2048 rows (launches from the
    # fused_ln run), #10 over its leaf set
    s13 = "4096x2048"
    kernels += [
        dict(flash_row("flash_attention_fwd", "o", "fwd", fwd_src, fwd_tpu,
                       dtype="bfloat16", fm=f13, path=g13[False]),
             dtype="bfloat16", shape="4x16x1024x128"),
        dict(flash_row("flash_attention_bwd_dq", "dq", "dq", bwd_src,
                       "paddle_tpu/ops/pallas/flash_attention.py:365",
                       fm=f13, path=g13[False]), shape="4x16x1024x128"),
        dict(flash_row("flash_attention_bwd_dkv", "dk", "dkv", bwd_src,
                       "paddle_tpu/ops/pallas/flash_attention.py:385",
                       fm=f13, path=g13[False]), shape="4x16x1024x128"),
        dict(ln_row("fused_add_layer_norm_fwd", "fwd", f"{ln_src}:134",
                    "gpt-1.3b", g13[True]), shape=s13),
        dict(ln_row("fused_add_layer_norm_bwd", "bwd", f"{ln_src}:165",
                    "gpt-1.3b", g13[True]), shape=s13),
        adamw_row("gpt-1.3b", g13["adamw"],
                  g13[False]["launches"]["fused_adamw_multi_update"]),
    ]
    # GPT-1.3B with bench's --recompute --fused-qkv --chunked-ce
    # --scan-layers (phase gpt-1.3b-options): #1, #3, #4 at its attention
    # shape (the forward twice a layer), launches over its 3 counted steps,
    # and #10 over the scanned model's leaf set
    kernels += [
        dict(flash_row("flash_attention_fwd", "o", "fwd", fwd_src, fwd_tpu,
                       dtype="bfloat16", fm=f13, path=g13o),
             dtype="bfloat16", shape="4x16x1024x128",
             path="gpt-1.3b-options"),
        dict(flash_row("flash_attention_bwd_dq", "dq", "dq", bwd_src,
                       "paddle_tpu/ops/pallas/flash_attention.py:365",
                       fm=f13, path=g13o), shape="4x16x1024x128",
             path="gpt-1.3b-options"),
        dict(flash_row("flash_attention_bwd_dkv", "dk", "dkv", bwd_src,
                       "paddle_tpu/ops/pallas/flash_attention.py:385",
                       fm=f13, path=g13o), shape="4x16x1024x128",
             path="gpt-1.3b-options"),
        adamw_row("gpt-1.3b-options", g13o["adamw"],
                  g13o["launches"]["fused_adamw_multi_update"]),
    ]
    # Llama-1B pretraining (phase llama-train, captured): #1, #3, #4 at
    # its attention shape with k/v expanded from 4 heads, dropout 0 (phase
    # llama-flash); "launches" the wrappers' counts over the main run (its
    # eager first step and its recording: the forward twice a layer with
    # recompute), "launches_recorded" what one replay launches
    lmain = next(r for r in lflash if "ms" in r)
    lrun = lt["captured"]
    for name, parts, timing, source, replaces in (
            ("flash_attention_fwd", ("o",), "fwd", fwd_src, fwd_tpu),
            ("flash_attention_bwd_dq", ("dq",), "dq", bwd_src,
             "paddle_tpu/ops/pallas/flash_attention.py:365"),
            ("flash_attention_bwd_dkv", ("dk", "dv"), "dkv", bwd_src,
             "paddle_tpu/ops/pallas/flash_attention.py:385")):
        bms, by = lmain["bound"][timing]
        kernels.append(dict(
            name=name, dtype="bfloat16", shape="4x16x1024x128 kv_heads 4",
            path="llama-train", route="cuda", source=source,
            replaces=replaces, launches=lrun["launches"][name],
            launches_recorded=lrun["recorded"][name],
            max_abs_err=max(r["err"][p] for r in lflash for p in parts),
            ms=lmain["ms"][timing], plain_ms=lmain["plain_ms"][timing],
            bound_ms=bms, bound_by=by,
            library_ms=lmain["library_ms"][timing]))
    # the 32 launches of one bf16 ResNet-50 serve forward, summed by shape
    cb = conv["total"]
    kernels.append(dict(
        name="fused_conv1x1_bn_act", route="cuda",
        source="paddle_tpu_torch/csrc/conv_bn_act.cu",
        replaces="paddle_tpu/ops/pallas/conv_bn_act.py:101",
        launches=rs["launches"]["fused_conv1x1_bn_act"],
        max_abs_err=max(r["max_abs_err"] for r in conv["rows"]
                        if r["dtype"] == "float32"),
        ms=cb["ms"], plain_ms=cb["plain_ms"], bound_ms=cb["bound_ms"],
        bound_by=cb["bound_by"], library_ms=None))
    # ... and the 17 launches of one resnet50 training forward, summed over
    # the same timed shapes; launches over phase resnet-train's 10 steps
    ct = conv["train_total"]
    kernels.append(dict(
        name="fused_conv1x1_bn_act", path="resnet-train", route="cuda",
        source="paddle_tpu_torch/csrc/conv_bn_act.cu",
        replaces="paddle_tpu/ops/pallas/conv_bn_act.py:101",
        launches=rt["fused"]["launches"]["fused_conv1x1_bn_act"],
        launches_per_forward=17,
        max_abs_err=max(r["max_abs_err"] for r in conv["rows"]
                        if r["dtype"] == "float32"),
        ms=ct["ms"], plain_ms=ct["plain_ms"], bound_ms=ct["bound_ms"],
        bound_by=ct["bound_by"], library_ms=None))
    # the high-level path (phases fit-resnet50 and fit-lenet): #11 over
    # Model.fit's 13 training steps at the training route's 17 shapes, and
    # over evaluate's and predict's f32 forwards (32 launches each); #10
    # over LeNet's 10 leaves, one launch a step over 6 epochs
    kernels.append(dict(
        name="fused_conv1x1_bn_act", path="fit-resnet50", route="cuda",
        source="paddle_tpu_torch/csrc/conv_bn_act.cu",
        replaces="paddle_tpu/ops/pallas/conv_bn_act.py:101",
        launches=fr["launches"]["fused_conv1x1_bn_act"],
        launches_per_forward=17,
        max_abs_err=max(r["max_abs_err"] for r in conv["rows"]
                        if r["dtype"] == "float32"),
        ms=ct["ms"], plain_ms=ct["plain_ms"], bound_ms=ct["bound_ms"],
        bound_by=ct["bound_by"], library_ms=None))
    ce = fr["conv_f32"]["total"]
    kernels.append(dict(
        name="fused_conv1x1_bn_act", dtype="float32",
        path="fit-resnet50 evaluate+predict", route="cuda",
        source="paddle_tpu_torch/csrc/conv_bn_act.cu",
        replaces="paddle_tpu/ops/pallas/conv_bn_act.py:101",
        launches=fr["eval_launches"], launches_per_forward=32,
        max_abs_err=max(r["max_abs_err"] for r in fr["conv_f32"]["rows"]),
        ms=ce["ms"], plain_ms=ce["plain_ms"], bound_ms=ce["bound_ms"],
        bound_by=ce["bound_by"], library_ms=None))
    kernels.append(dict(
        adamw_row("fit-lenet", fl["adamw"],
                  fl["launches"]["fused_adamw_multi_update"]),
        launch_floor_ms=adamw["launch_floor_ms"]))
    # #1 f32 at DETR's head_dim 32, timed at its encoder's shape; launches
    # over one detr-serve forward
    de = d32["timed"]
    kernels.append(dict(
        name="flash_attention_fwd", dtype="float32", shape="8x8x1050x1050x32",
        path="detr-serve", route="cuda", source=fwd_src, replaces=fwd_tpu,
        launches=dt["launches"]["flash_attention_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in d32["rows"]),
        ms=de["ms"], plain_ms=de["plain_ms"], bound_ms=de["bound_ms"],
        bound_by=de["bound_by"], library_ms=de["library_ms"]))
    # detection training (phase detr-train): #1 f32 at head_dim 32 timed
    # at DETR's encoder at detr-train's batch (4 x 8 x 1050 x 1050), #3 and
    # #4 at each of DETR's three attention shapes at that batch, all with
    # dropout 0.1 as detr-train runs them (the backward's 3xTF32 bound,
    # its CUDA-core one beside), launches over its steps (#3/#4: at that
    # shape), and #10 over DETR's leaf set under a clip scale (phase adamw)
    dbw = d32["bwd"]
    for name, parts, timing, replaces, shapes in (
            ("flash_attention_fwd", ("o",), "fwd", fwd_tpu,
             DETR_ATTENTION[:1]),
            ("flash_attention_bwd_dq", ("dq",), "dq",
             "paddle_tpu/ops/pallas/flash_attention.py:365", DETR_ATTENTION),
            ("flash_attention_bwd_dkv", ("dk", "dv"), "dkv",
             "paddle_tpu/ops/pallas/flash_attention.py:385",
             DETR_ATTENTION)):
        for where, sq, sk in shapes:
            db = dbw["timed"][(where, 0.1)]
            bms, by = db["bound"][timing]
            row = dict(
                name=name, dtype="float32", shape=f"4x8x{sq}x{sk}x32",
                path="detr-train", route="cuda",
                source=fwd_src if timing == "fwd" else bwd_src,
                replaces=replaces,
                launches=(dtr["launches"][name] if timing == "fwd" else
                          dtr["bwd_shapes"][(sq, sk)]),
                max_abs_err=max(r["err"][p] for r in dbw["rows"]
                                for p in parts),
                ms=db["ms"][timing], plain_ms=db["plain_ms"][timing],
                bound_ms=bms, bound_by=by,
                library_ms=db["library_ms"][timing])
            if timing != "fwd":
                row["bound_cores_ms"] = db["bound_cores"][timing][0]
            kernels.append(row)
    kernels.append(adamw_row(
        "detr-train", adamw["multi"][("detr-r50", True)],
        dtr["launches"]["fused_adamw_multi_update"]))
    # the captured training steps (phase train-graph): the same kernels,
    # replayed from each path's CUDA graph. "launches" counts the wrappers
    # over the captured Engine's steps (its eager first step and its
    # recording), "launches_recorded" what one replay launches again
    def pick(name, **match):
        return next(r for r in kernels if r["name"] == name and all(
            r.get(k) == v for k, v in match.items()))

    graph_rows = [
        (pick("flash_attention_fwd", dtype="bfloat16", shape=None),
         "gpt3-345M"),
        (pick("flash_attention_bwd_dq", shape=None, path=None), "gpt3-345M"),
        (pick("flash_attention_bwd_dkv", shape=None, path=None), "gpt3-345M"),
        (pick("fused_adamw_multi_update", path="train"), "gpt3-345M"),
        (pick("fused_adamw_multi_update", path="ernie"), "ernie-3.0-base"),
        (pick("fused_add_layer_norm_y_fwd"), "ernie-3.0-base"),
        (pick("fused_add_layer_norm_y_bwd"), "ernie-3.0-base"),
        (pick("flash_attention_fwd", shape="4x16x1024x128"), "gpt3-1.3B"),
        (pick("flash_attention_bwd_dq", shape="4x16x1024x128"),
         "gpt3-1.3B"),
        (pick("flash_attention_bwd_dkv", shape="4x16x1024x128"),
         "gpt3-1.3B"),
        (pick("fused_adamw_multi_update", path="gpt-1.3b"), "gpt3-1.3B"),
        (pick("fused_conv1x1_bn_act", path="resnet-train"), "resnet50"),
    ]
    for row, path in graph_rows:
        res = tg[path]
        kernels.append(dict(
            row, path=f"train-graph {path}",
            launches=res["launches"][row["name"]],
            launches_recorded=res["recorded_launches"][row["name"]]))
    # float16 AMP training under TrainGuard (phase fp16-guard): #1, #3, #4
    # in float16 timed at GPT's training shape (dropout 0.1) and at D = 128
    # (4 x 16 x 1024), beside SDPA in float16; "launches" the wrappers'
    # counts over the main run (its eager first step and its recording),
    # "launches_recorded" the float16 nodes of its one graph; and #10 as
    # the guarded step launches it (1/scale as the gradient scale, the skip
    # flag read), over GPT-345M's leaf set
    fmain16, f128_16 = fg["rows"][0], fg["rows"][1]
    fgm = fg["main"]
    for name, parts, timing, source, replaces in (
            ("flash_attention_fwd", ("o",), "fwd", fwd_src, fwd_tpu),
            ("flash_attention_bwd_dq", ("dq",), "dq", bwd_src,
             "paddle_tpu/ops/pallas/flash_attention.py:365"),
            ("flash_attention_bwd_dkv", ("dk", "dv"), "dkv", bwd_src,
             "paddle_tpu/ops/pallas/flash_attention.py:385")):
        for fm, shape in ((fmain16, "8x16x1024x64"),
                          (f128_16, "4x16x1024x128")):
            bms, by = fm["bound"][timing]
            kernels.append(dict(
                name=name, dtype="float16", shape=shape, path="fp16-guard",
                route="cuda", source=source, replaces=replaces,
                launches=fgm["launches"][name],
                launches_recorded=fgm["recorded"][name],
                max_abs_err=max(r["err"][p] for r in fg["rows"]
                                for p in parts),
                ms=fm["ms"][timing], plain_ms=fm["plain_ms"][timing],
                bound_ms=bms, bound_by=by,
                library_ms=fm["library_ms"][timing]))
    ga = fg["adamw"]
    kernels.append(dict(
        name="fused_adamw_multi_update", path="fp16-guard",
        shape=f"{ga['leaves']} leaves, {ga['values']} values, guarded",
        route="cuda", source="paddle_tpu_torch/csrc/fused_adamw.cu",
        replaces="paddle_tpu/ops/pallas/fused_adamw.py:68",
        launches=fgm["launches"]["fused_adamw_multi_update"],
        launches_recorded=fgm["recorded"]["fused_adamw_multi_update"],
        max_abs_err=ga["max_abs_err"], ms=ga["ms"],
        skipped_ms=ga["skipped_ms"], plain_ms=ga["plain_ms"],
        bound_ms=ga["bound_ms"], bound_by=ga["bound_by"],
        library_ms=ga["library_ms"]))
    # float16 #6-#9 and #11 (phase fp16-kernels, timed beside their bf16
    # instantiations in "bf16_ms"): #6/#7 at GPT's rows, launched on
    # fp16-guard's gpt3-345M fused_ln run; #8/#9 at ERNIE's, launched on
    # fp16-ernie's main run; #11 summed over a training forward's 17
    # launches, launched on fp16-resnet's Model.fit. "launches" counts the
    # wrappers over the run (its eager first step and its recording),
    # "launches_recorded" the float16 nodes of its one graph
    ln_f16 = fg["gpt_fused_ln"], fe["main"]
    for name, part, line, shape, run in (
            ("fused_add_layer_norm_fwd", "fwd", 134, "gpt", ln_f16[0]),
            ("fused_add_layer_norm_bwd", "bwd", 165, "gpt", ln_f16[0]),
            ("fused_add_layer_norm_y_fwd", "y_fwd", 267, "ernie", ln_f16[1]),
            ("fused_add_layer_norm_y_bwd", "y_bwd", 294, "ernie",
             ln_f16[1])):
        tm = fk["ln_timing"][shape]["float16"]
        bms, by = tm["bound"][name]
        kernels.append(dict(
            name=name, dtype="float16",
            shape="8192x1024" if shape == "gpt" else "16384x768",
            path="fp16-guard" if shape == "gpt" else "fp16-ernie",
            route="cuda", source="paddle_tpu_torch/csrc/fused_ln.cu",
            replaces=f"{ln_src}:{line}", launches=run["launches"][name],
            launches_recorded=run["recorded"][name],
            max_abs_err=max(r["err"][part] for r in fk["ln_rows"]),
            max_ulps=fk["ln_ulps"], ms=tm["ms"][name],
            bf16_ms=fk["ln_timing"][shape]["bfloat16"]["ms"][name],
            plain_ms=tm["plain_ms"][name], bound_ms=bms, bound_by=by,
            library_ms=tm["native_bwd_ms"] if "bwd" in name else None))
    c16 = fk["conv_train_total"]
    kernels.append(dict(
        name="fused_conv1x1_bn_act", dtype="float16", path="fp16-resnet",
        route="cuda", source="paddle_tpu_torch/csrc/conv_bn_act.cu",
        replaces="paddle_tpu/ops/pallas/conv_bn_act.py:101",
        launches=fres["main"]["launches"]["fused_conv1x1_bn_act"],
        launches_recorded=fres["main"]["recorded"]["fused_conv1x1_bn_act"],
        launches_per_forward=17,
        max_abs_err=max(r["max_abs_err"] for r in fk["conv_rows"]),
        ms=c16["ms"], bf16_ms=c16["bf16_ms"], plain_ms=c16["plain_ms"],
        bound_ms=c16["bound_ms"], bound_by=c16["bound_by"],
        library_ms=None))
    # MobileNetV2 through Model.fit (phase zoo-train): #10 over its 158
    # leaves, the captured Engine's counts (its eager first step and its
    # recording) and a replay's
    kernels.append(dict(
        adamw_row("zoo-train mobilenet_v2", zt["adamw"],
                  zt["launches"]["fused_adamw_multi_update"]),
        launches_recorded=zt["recorded_launches"][
            "fused_adamw_multi_update"]))
    # the DENSE kernels of #1, #3, #4 (phase masked-flash, timed at
    # ERNIE's fine-tune shape with its padding mask, dropout 0.1) on the
    # fine-tune's path (phase ernie-finetune): "launches" the masked
    # launches over the captured fit (its eager first step and its
    # recording), "launches_per_step" the masked nodes of a replayed step;
    # "unmasked_ms" the plain kernels on the same inputs, "library_ms" SDPA
    # with the same attn_mask
    for dtype in ("bfloat16", "float32"):
        mt = mflash["timed"][dtype]
        run = eft[dtype]
        for name, parts, timing, source, replaces in (
                ("flash_attention_fwd", ("o",), "fwd", fwd_src, fwd_tpu),
                ("flash_attention_bwd_dq", ("dq",), "dq", bwd_src,
                 "paddle_tpu/ops/pallas/flash_attention.py:365"),
                ("flash_attention_bwd_dkv", ("dk", "dv"), "dkv", bwd_src,
                 "paddle_tpu/ops/pallas/flash_attention.py:385")):
            bms, by = mt["bound"][timing]
            kernels.append(dict(
                name=name, dtype=dtype, mask="padding [B, 1, 1, Sk] bool",
                shape=f"{ERNIE_FT_B}x12x{ERNIE_FT_S}x{ERNIE_FT_S}x64",
                path="ernie-finetune", route="cuda", source=source,
                instantiation="DENSE", replaces=replaces,
                launches=run["masked_launches"][name],
                launches_per_step=run["per_step"][name],
                max_abs_err=max(r["err"][p] for r in mflash["rows"]
                                if r["dtype"] == dtype for p in parts),
                ms=mt["ms"][timing], unmasked_ms=mt["unmasked_ms"][timing],
                plain_ms=mt["plain_ms"][timing], bound_ms=bms, bound_by=by,
                library_ms=mt["library_ms"][timing],
                library_backend=mt["library_backend"]))
    # each kernel's float16 status on the card: ported where a float16 row
    # was held above, what fp16-guard saw raise (still to port: ROADMAP.md
    # queue 2), else no float16 operand (#10's leaves stay f32 under O1)
    f16_rows = {kr["name"] for kr in kernels if kr.get("dtype") == "float16"}
    for kr in kernels:
        kr["float16"] = "; ".join(
            (["ported"] if kr["name"] in f16_rows else [])
            + fg["refused"].get(kr["name"], [])) or "takes f32 only"
    # every timed number of the table held (the values) and unheld
    for kr in kernels:
        kr["unheld"] = {key: unheld(kr[key])
                        for key in ("ms", "plain_ms", "library_ms")}
        u = kr["unheld"]
        log(f"kernels: {kr['name']}"
            + (f" ({kr['dtype']})" if "dtype" in kr else "")
            + (f" at {kr['shape']}" if "shape" in kr else "")
            + (f" on {kr['path']}" if "path" in kr else "")
            + f": ms {kr['ms']:.4f} (unheld "
            f"{u['ms']:.4f}), plain_ms {kr['plain_ms']:.4f} (unheld "
            f"{u['plain_ms']:.4f}), library_ms "
            + ("none" if kr["library_ms"] is None else
               f"{kr['library_ms']:.4f} (unheld {u['library_ms']:.4f})")
            + f", bound_ms {kr['bound_ms']:.4f}, launches {kr['launches']}"
            + (f", the launch floor {kr['launch_floor_ms']:.4f}"
               if "launch_floor_ms" in kr else ""))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
