#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):
  1. build the CUDA kernels from vlut_tpu_torch/csrc with nvcc (sm_90a);
  2. hold every kernel against its plain PyTorch version on the card at the
     serving path's shapes, and time kernel, plain version, one library call
     and the card's lower bound for the same work (kernel and library call
     timed inside a CUDA graph, so the time is the device's); #7 / #8 also
     past heads of 512 (bench/attention_study.py:SHAPES: DeepSeek-V2-Lite's
     latent widths 640 / 512, 1024 / 1024, 128 / 2048, 2048 / 128, 4096 /
     4096, G 7 at 768), with the SDPA backend that ran and the composed
     step's row write and attention timed beside the kernel;
  3. the flagship: llama3_8b_158 at full width and depth, prefill 32 x 128
     plus greedy batched decode (vlut_tpu_torch/bench/flagship.py), with the
     composed decode attention (row write #5 + PyTorch) and the fused one
     (#7), each with the decode step replayed as a CUDA graph (the main
     path, counted) and then eagerly (the A/B): identical greedy tokens;
  4. real weights: tests/fixtures/tiny_real through the port's ``batched``
     path on the card (graphed and eager) and on the CPU: identical greedy
     tokens; seeded sampling graphed and eager: identical tokens;
  5. the slot engine at the flagship's full width: 32 slots, ctx 2048, 40
     greedy requests of 64-1100 prompt tokens (vlut_tpu_torch/bench/
     engine.py), with the bf16 and the q8 cache, each with the fused and
     the composed decode attention (the A/B of ms per decode step), each
     graphed (the main path) and eager: identical greedy tokens; the fused
     runs profile 4 decode steps (kernels, launch calls, idle share), and
     the graphed ones hold each fused layer (from the composed step's
     input) within ``bench/engine.py:PATHS_X`` of the noise floor of the
     composed one (``paths_ok``; ``bench/paths_check.py`` shows it
     failing wiring faults at full width);
  6. tiny_real through the engine on the card (graphed and eager) and on
     the CPU, bf16 and q8 cache: identical greedy tokens; seeded sampling
     (temperature 0.8, top-k 40, XTC, mirostat rows) graphed and eager on
     the card: identical tokens;
  7. the completion server over the flagship engine (tiny_real's tokenizer
     for text): 8 concurrent /completion requests, one streaming, must
     answer 200 with the tokens of a direct Engine.run;
  8. the kernel microbenchmark (vlut_tpu_torch/bench/kernels.py) at the
     llama3_8b shapes, M 32 and 256: i2/i1 through #3, TQ2_0/TQ1_0 through
     #9, one JSON line per row;
  9. the end-to-end benches (vlut_tpu_torch/bench/e2e.py): bench_sweep of
     llama3_8b_158 at full width and depth in i2 and in i1 (pp 512, tg 32,
     batch 1 and 32) and one batched_bench (npp 128, ntg 32, npl 32);
 10. perplexity of tiny_real over the first 1,024 bytes of SURVEY.md
     (window 128) on the card and on the CPU (relative 1e-4), and the
     quantized-vs-dequant KL on the card (mean < 0.05, top-1 > 0.95);
 11. tiny_real requantized to i1 (convert/quantize.py) gives the i2
     model's greedy ``batched`` tokens on the card; ``inspect`` of both;
 12. speculative decoding at full width: the flagship engine (32 slots, ctx
     2048, 32 greedy requests of 128-512 prompt tokens, 32 new tokens)
     with a random bitnet_2b_4t draft (seed 1, the same vocabulary), k 4,
     graphed rounds against eager ones (identical tokens); ms and tokens
     per round, drafted and accepted counts, the round program's launches,
     and the share of tokens equal to the plain engine's (printed, not
     gated: the random flagship turns rounding into other tokens); then the
     flagship as its own draft;
 13. lookahead at full width: the same engine and requests with W 4, G 3
     (T 11 rows per slot, M 352), graphed against eager;
 14. tiny_real on the card and on the CPU (identical tokens): draft mode
     (itself, and itself with its last layer dropped) and lookahead (their
     tokens equal plain greedy), prompt lookup through the CLI (card text
     equals the CPU's and plain greedy's), a GBNF and a json_schema request
     (their outputs parse under their grammars), a random rank-8 LoRA
     adapter written as safetensors and loaded by ``load_peft_adapter``,
     and a control vector (each changes the tokens);
 15. grammar at full width: 8 flagship slots under a JSON schema over a
     synthetic 128,256-piece vocabulary made from the seed, graphed
     against eager, every output accepted by its grammar; host ms of the
     masks against the step's;
 16. LoRA at full width: a random rank-16 adapter on wq/wv/w_up (the
     unfused tree, #4 per projection at decode), 32 slots, graphed against
     eager, ms per step against the fused model's;
 17. slot save/restore on the flagship engine: a slot saved after its
     request, erased, restored into another slot of the captured engine;
     the continuation equals the original slot's;
 18. the rest of the server over the flagship engine (32 slots, ctx 2048,
     graphed; tiny_real's tokenizer): 8 concurrent greedy chats (one
     streamed, one with n 4) equal a direct Engine.run of the templated
     ids, /apply-template, /infill equals /completion of the prefix,
     /v1/embeddings of 32 inputs (M 4096, #3) in mean, last and cls
     bit-equal to a direct forward(output="hidden") pooled on the card,
     /v1/rerank of 32 documents (M 8192) equal to a direct call and within
     1e-5 of a whole-logits forward, an embedding sent while 8 streamed
     completions decode (their tokens unchanged); tiny_real on the card
     against the CPU (chat, a tool_choice "required" chat whose pieces
     parse as a call, embeddings, rerank, infill); the web UI, routing by
     "model" and a 404; ``generate --promote i1`` against the requantized
     checkpoint; ms per embeddings batch and rerank, #3's device launches
     per embeddings batch;
 19. the dense zoo (vlut_tpu_torch/bench/zoo.py): qwen3_4b at full width
     and depth (16 slots, ctx 2048, 16 greedy requests of 64-512 prompt
     tokens, 16 new tokens) with bf16 fused (#7), q8 fused (#8) and bf16
     composed attention, and gemma2_2b at full width and depth (8 slots,
     ctx 8192, one request of 5,000 tokens past its 4,096 window and 8
     of 64-512, the ninth admitted beside the long one's decode,
     composed: its softcap gate), each graphed against
     eager (identical tokens), with ms per decode step, prompt tok/s and
     the tied head's time; falcon-7b (its published config.json typed in
     ``bench/zoo.py:FALCON_7B``, through the port's ``config_from_hf``: d
     4544, 32 layers, 71 heads of 64 over one KV head, parallel attention,
     vocabulary 65024; random packed weights from seed 19) through the
     engine (16 slots, ctx 2048, 16 greedy requests of 64-1000 prompt
     tokens, 16 new tokens): bf16 fused (#7 in five head groups) graphed
     and eager (identical tokens), q8 fused (#8) and bf16 composed (#5)
     graphed, #7 / #8 launched 32 a step, each fused layer (from the
     composed step's input) within ``bench/engine.py:PATHS_X`` of the
     noise floor of the composed one; heads of 576 (padded to 640: #7 /
     #8's wide path) in ``tiny``'s fields, 2 layers, through the engine,
     bf16 and q8 fused, graphed = eager = the CPU's tokens, #7 / #8 two a
     step, each fused layer within ``PATHS_X`` of the floor, the composed
     step (#5 / #6) graphed and timed beside the fused one; then each
     knob family of the CPU tests (d 256,
     heads of 128, 2 layers) on the card against the CPU (each layer from
     the CPU's input and the logits within 2e-2 of the largest, the CPU's
     greedy tokens) and graphed against eager; every kernel the JAX gates
     send a model to must count launches;
 20. heterogeneous stacks and MoE: ``mixtral_8x7b`` (Mixtral-8x7B's
     published widths: d 4096, 32 layers, 32/8 heads of 128, 8 experts of
     14336, top 2, vocabulary 32000) at full width and depth, random packed
     weights from seed 0, through the engine (16 slots, ctx 2048, 16 greedy
     requests of 64-512 prompt tokens, seed 13, 16 new tokens): bf16 fused
     (#7) graphed and eager (identical tokens; the graphed run profiles 4
     steps), q8 fused (#8) and bf16 composed (#5) graphed, every expert's
     gate, up and down through #4 at decode and #3 at prefill; then each
     MoE and per-layer family of ``bench/zoo.py`` (router kinds, shared,
     chunk and residual experts, dense lead layers, per-layer heads, deci's
     layer kinds) on the card against the CPU, layer by layer, and graphed
     against eager;
 21. MLA, M-RoPE and the stacked cache: ``deepseek_v2_lite``
     (DeepSeek-V2-Lite's published widths: d 2048, 27 layers, 16 MLA heads
     over a latent of 512 with rope 64, 64 experts of 1408, top 6, 2
     shared experts, one dense lead layer of 10944, vocabulary 102400) at
     full width and depth, random packed weights from seed 0, through the
     engine (16 slots, ctx 2048, 16 greedy requests of 64-512 prompt
     tokens, seed 14, 16 new tokens): bf16 graphed (4 steps profiled),
     bf16 eager for 4 new tokens (the graphed run's first tokens), q8
     graphed, and one request past a 512-row context (the latent rows'
     context shift); every latent row write through #5, every MLA
     projection and expert through #4 at decode and #3 at prefill, wo
     through #1; then each MLA and M-RoPE family of ``bench/zoo.py`` on the
     card against the CPU, layer by layer, and graphed against eager; then
     ``Engine(unroll=False)`` over a stacked cache on tiny_real and on an
     MLA family: the unrolled engine's tokens;
 22. the recurrent families: ``mamba_2_8b`` (Mamba-2.8B's published widths:
     d 2560, 64 layers, state 16, conv 4, expand 2, dt rank 160, vocabulary
     50280, tied embeddings) at full width and depth, random packed weights
     from seed 0, through the engine (16 slots, ctx 2048, 16 greedy
     requests of 64-1000 prompt tokens, seed 15, 16 new tokens) graphed (4
     steps profiled) and eager (identical tokens), every in_proj / out_proj
     through #4 at decode and #3 at prefill, the launches of one decode step
     and of one 1000-token prefill; one completion through the server (its
     tokens a direct engine run's); a 2,500-token prompt past the largest
     prefill bucket (two 1,024-token chunks, each continuing its slot's
     state, and a left-padded remainder) beside a 300-token one, graphed
     and eager (identical tokens), its chunk forwards counted;
     ``codestral_mamba_7b`` (Mamba2 at Mamba-Codestral-7B's widths: d 4096,
     64 layers, 128 heads of 64, 8 groups, state 128, vocabulary 32768)
     through ``generate``'s
     state-carrying loop, greedy and seeded; then each family of
     ``bench/recurrent_zoo.py`` (Mamba, Mamba2, RWKV7, arwkv7, RWKV6 and 11
     hybrid cases) on the card against the CPU, layer by layer, and a tiny
     Mamba engine graphed, eager and on the CPU (identical tokens);
 23. the encoder half: ``llada_8b`` (LLaDA-8B's published widths: d 4096,
     32 layers, 32 heads over 32 KV heads, mlp 12288, vocabulary 126464,
     the mask token 126336, in-place logits) at full width and depth,
     random packed weights from seed 0, denoised by ``diffusion_generate``
     over the packed tree (128 prompt tokens of seed 16, 128 new, 128
     steps, blocks of 32, low_confidence, greedy: each step one
     bidirectional forward at M 256 through #3) twice, identical tokens
     and no mask token left, with a profile of one forward; then each
     family of ``bench/encoder_zoo.py`` on the card against the CPU (bert,
     modernbert, neobert, nomic-bert, nomic-bert-moe, jina-bert-v2/v3, T5
     gated and ungated, gemma3n; llada, dream and llada_moe packed and as
     float twins through the denoise loop, #1 / #4 at T 40); ``cli embed``
     and an embedding-only server (``/v1/embeddings`` the CPU's, 400 on
     ``/completion``); ``cli generate`` on a diffusion checkpoint (its
     float twin) and a T5 checkpoint, the CPU's text; ModernBERT-base's
     widths timed per ``embed`` batch of 32 x 512;
 24. the HF converter (vlut_tpu_torch/convert/convert.py): ``llama3_8b_158``
     at full width and depth, random packed weights from seed 24, written
     by ``bench/hf_writer.py`` in HF1BitLLM's layout (packed uint8
     projections, bf16 ``weight_scale`` = 1 / scale, bf16 embedding and
     head), converted by ``cli convert`` on the card and loaded: every leaf
     the tree written (each scale ``1 / weight_scale``), bit for bit; then
     served by ``bench/flagship.py`` (fused graphed and eager, identical
     tokens, and composed: #1, #3, #7 and #5); the seconds and GB/s of
     writing, converting and loading; an HF1BitLLM llama, a mixtral and a
     mamba (tiny widths) converted on the card and on the CPU, equal
     checkpoints, each served on the card against the CPU, layer by layer;
     tiny_real written as an HF directory, converted by ``cli convert`` on
     the card and on the CPU (equal) and ``cli generate``: the CPU's text;
     the host packer (convert/native.py, g++) at llama3_8b_158's widths:
     two layers' projections, padded by ``pad_weight``, packed by
     ``pack_ternary`` natively, by torch on the host and by torch on the
     card, the bytes equal (and ``pack_weight``'s on the card), seconds and
     GB/s of each, the build's seconds; ``ternarize_absmean`` and
     ``detect_ternary`` against the port's numpy ternarize and the
     converter's exact-ternary check on a full-width matrix;
 25. the trainer (vlut_tpu_torch/train/finetune.py): ``bitnet_2b_4t`` at
     its published widths (d 2560, 30 layers, 20/5 heads, d_ff 6912,
     vocabulary 128256, sub-norms), random packed weights from seed 25,
     its float32 twin on the card, three QAT steps of AdamW on one seeded
     batch of 4 x 256 tokens and a fourth profiled (the loss finite and
     falling), ``pack_params`` (two projections equal to the CPU's packing
     of the same masters), saved, loaded and served through the slot
     engine (8 slots, ctx 1024, 12 greedy requests), fused graphed and
     eager (identical tokens) and composed: #1, #3, #7 and #5 counted;
     then one case of each family converter (T5, gemma3n, bert, RWKV7,
     jamba) written by ``bench/hf_writer.py``, converted on the card and
     on the CPU (equal, and the tree written) and served on the card
     against the CPU;
 26. the vision half: ``llava_1_5_7b`` (llava-hf/llava-1.5-7b-hf's widths:
     CLIP ViT-L/14-336, d 1024, 24 layers, feature layer -2, 576 patch
     rows; a 1024 -> 4096 -> 4096 projector; Llama-2-7B's text, d 4096, 32
     layers, 32/32 heads of 128, d_ff 11008, vocabulary 32064) at full
     width and depth, random weights from seed 26 (the tower bf16, the
     text packed i2 with an int8 head), ``cli.describe`` of a seeded 336 x
     336 image array with a prompt holding <image> (tiny_real's
     tokenizer): one prefill of the spliced rows through #3, 32 greedy
     tokens through #1 and #7, the step a CUDA graph (twice, and eager:
     identical tokens), then composed through #5; the tower's, the
     projector's, the prefill's and a token's times, and their profiles; then every family of ``bench/vision_zoo.py`` (the JAX
     vision tests' sources converted on the card and on the CPU: equal
     files; each tower function on the card from the CPU's inputs; the
     CPU's embeddings spliced into the language model on both, layer by
     layer, the CPU's greedy tokens; cogvlm's visual-expert pass; the
     twins' towers);
 27. the audio half: ``describe --audio`` at full width (the whisper-large-v3
     encoder, d 1280, 32 layers, 20 heads, d_ff 5120, 128 mels, 1500
     positions, and the ultravox projector, stack 8, 4096 hidden, into the
     flagship of phase 3; float32 from seed 27): a seeded WAV of whisper's
     3000 frames through ``save_wav``, ``load_wav``, ``log_mel`` and
     ``encode`` (188 rows), ``cli.describe`` of a prompt holding <audio>
     (tiny_real's tokenizer): 32 greedy tokens through #3, #1 and #7 graphed
     (twice, and eager: identical tokens), then composed through #5; the
     log-mel's, tower's, projector's, prefill's and a token's times and a
     profile; ``tts`` at full width (``outetts_0_2_500m``: d 896, 24 layers,
     14/2 heads of 64, d_ff 4864, q/k/v biases, vocabulary 157,696; the
     WavTokenizer vocoder at ``VocoderConfig``'s defaults; seed 27): a
     seeded 20-word speaker profile (each code, duration and markup one
     token, as OuteTTS-0.2 tokenizes them), guide tokens, top-k 4, 256 tokens, the
     prefill through #3 and each step (#4, #1, #7 at G 7, 24 launches a
     step and no #5; a CUDA graph) twice (one stream; an eager run its
     first 32 tokens), the step's device and the host's sampling times
     apart; the step composed (#5) for 64 tokens beside it (graphed ms,
     device ms by kernel, launches) and each fused layer within
     ``PATHS_X`` of the noise floor of the composed one; and
     ``codes_to_audio`` of 750 seeded codes (10 s); then every
     family of ``bench/audio_zoo.py`` (five projectors, lfm2-a's conformer,
     the vocoder + ISTFT) card against CPU, and ``convert-audio`` ->
     ``describe --audio`` and ``convert-vocoder`` -> ``tts`` on tiny_real:
     the CPU's text and WAV;
 28. the bench tooling: ``bench/ablate.py``'s seven configurations (full,
     unfused, no_kv_write, no_attn, no_head, gemms_only, layer_gemms_only)
     on phase 3's flagship, the marginal ms a graphed step, under the
     composed and the fused decode attention (no_kv_write alone is not
     applicable to the fused one); the autotune table's lookups on the
     card it was measured on;
 29. the serving half of the mesh (``mesh_phase``): ``llama3_8b_158`` at
     full width and depth through ``Engine(mesh=)`` at tp 2, two gloo
     ranks sharing this card (32 slots, 128-token prompts, 8 greedy
     tokens; prefill and first-step logits against the single-device
     forward, the census of a decode step, ms per step beside a
     single-device engine's); tiny_real at tp 2 (bf16, q8, composed) and
     dp 2 (tokens equal to the CPU's ranks') and on one NCCL rank, graphed;
     ``mixtral_8x7b``'s widths (4 layers) at ep 2; sp 2 and pp 2 at the
     flagship's widths over 2 layers;
 30. the train half of the mesh (``train_mesh_phase``):
     ``llama3_8b_158``'s widths over 8 of its 32 layers (the float32 twin at
     full depth is about 32 GB of weights alone), two gloo ranks sharing
     this card: one SGD step of the float32 twin on one device, then the
     same step at tp 2 (``make_sharded_train_step``), every leaf and its
     update gathered and held to the single-device step (``bench/mesh.py``'s
     ``TRAIN_*`` limits: JAX's own sharded test's, and the update's); three
     QAT steps at tp 2, the tree gathered, packed and served on one device
     (graphed tokens = eager) and at tp 2 (phase 29's layer-by-layer check);
     a slot saved from the tp-2 engine (its K/V the ranks' heads bit for
     bit), restored into a fresh tp-2 engine (read back bit-equal, the
     uninterrupted run's tokens) and into a single-device engine (read back
     bit-equal);
 31. one JSON line of every kernel with its launches on the paths of phases
     3-30, then the card, then ``{"ok": true, "device": ...}`` last.

Phase 2 holds its plain versions' float32 products in full float32;
phases 3-28 run with TF32 allowed for matmuls and cuDNN convolutions, as a
caller may allow it: every float32 entry of the port holds TF32 off itself
(``device.full_float32``), so the card = CPU checks hold under it.

Phase 2 also times #3 at each tile entry of the card's autotune table
(``vlut_tpu_torch/bench/autotune_h100.json``) against ``tiled_plan``'s tiles
(printed, not gated), holds #3 bit-exact at every entry's tiles at its
key's shape, and ``ternary_matmul``'s two routes at M <= 64 (#4, and the
same int8 quantization then #3) array-equal at each route entry (with
none, at the route sweep's shapes at M 1 and 64).
Phase 2 draws its inputs from a seed taken from the OS and printed (its
first JSON line), and runs its untimed checks in an order that seed
shuffles (printed in the ``kernels_checks`` line): no check may hold only
for the data an earlier draw left.  #1 and #4's float prologues (norm,
silu*up, sub-norm) are held bit for bit, codes, scales and output, to
``ops/ternary_gemm.py:decode_input_kernel_order``, the emulation of the
kernel's own order of operations.
Phase 2 times #3 (the tiled GEMM) at the flagship prefill (M 4096) and at
the microbenchmark's i2 lanes (llama3_8b dxd, dxff, ffxd at M 32 and 256)
beside two yardsticks on the unpacked trits: ``torch._int_mm`` with the
weight row-major and column-major (the faster is its ``library_ms``) and
one float16 matmul; #1 and #4 beside the same three calls (the fastest is
their ``library_ms``), with their prologue and GEMM also timed apart, and
one profiled call of each (with and without a split of K) that must run at
most two device kernels.  It also holds #9 (the TQ2_0/TQ1_0 GEMM) against
its plain version at the llama3_8b shapes (dxd, dxff, ffxd) for both
formats at M 32 and 256, with the plan of each: the float32 sum runs in the
same order in both, so they must be equal bit for bit (max |err| 0).  It
then checks, without timing them, the kernels at the shapes the later
phases give them: #1 at every flagship projection in i2 and i1 at M 1,
17, 32, 33 and 64 (the e2e benches' decode is M 1 and 32), and bit-exact at
shapes that make its plan take every kernel instantiation and split count
(with every tile and split forced at two), #3 bit-exact in i2 and i1 at the
microbenchmark's lanes (M 32 and 256), at the e2e prefills (M 512 and
16384), at the speculative verify's and the lookahead round's M (160 and
352) and at the server's rerank (M 8192), and at shapes that make its plan
take each tile and split of K, #1 at the draft model's (bitnet_2b_4t's)
four projections at M 32, the zoo presets' projections (qwen3_4b's four
and gemma2_2b's qkv through #1, gemma2_2b's wo, gate|up and down through
#4) at M 1, 32 and 64 and through #3 at their prefills' M 1024 and 4096
(and times them at their engines' decode M, 16 and 8, and through #3 at
M 512; #7/#8 at qwen3_4b's engine, B 16 S 2048, which is also
mixtral_8x7b's, at a sliding layer of gemma2_2b's heads, hd 256, window
4,096 past 5,000 rows, and at a heterogeneous stack's narrower layer, 2
query heads over its own KV head), mixtral_8x7b's qkv and wo through #1
and each expert's gate / up (4096 -> 14336) and down (14336 -> 4096)
through #4 at M 1, 16, 32 and 64 and through #3 at M 512, 1024 and 4096
(phase 20's shapes), mamba_2_8b's and codestral_mamba_7b's in_proj and out_proj
through #4 at M 1, 16 and 64 and #3 at their prefills' M (phase 22's
shapes), deepseek_v2_lite's wo through #1 and its wq_full,
wkv_a (576 wide, packed to 640), each expert's, the shared experts' and
the dense lead layer's projections through #4 at M 1, 16, 32 and 64 and
through #3 at M 512, 1024 and 4096 (phase 21's shapes), llada_8b's fused
tree (qkv, wo, gate|up, down) through #1 timed at M 32 and checked at M 1,
32 and 64, and through #3 timed at M 256 (the denoise forward) and checked
at M 256 and 1024 (phase 23's shapes), its unfused wq, w_gate and w_down
through #4 timed at M 32 and checked at M 1, 32 and 64, #1 and #4 at the
flagship's projections at the
server's small embedding batches (M 16 and 48), the audio half's
(phase 27: the flagship's four through #1 at M 1 and through #3 timed at
``describe --audio``'s prefill M, #7 timed at its cache, B 1;
outetts_0_2_500m's seven timed at M 1 as its gates send them, wo through
#1 and the rest through #4, checked at M 1, 32 and 64, and through #3
timed at its tts prefill's M and checked there and at M 1024; #5 timed at
its cache, one slot of 8,192 rows, 2 KV heads of 128), #9
bit-exact at shapes that make its plan take each tile and split count and
with every tile and split forced at two shapes, #7 at the e2e benches'
caches, and #7 and #8 at shapes that make attn_plan take each rows-per-block
choice (every choice forced at two), at B 1, at the edge starts (0, S - 1,
out of range: the write skipped) with large finite values in the rows a
slot does not see, and replayed from a CUDA graph (cache bit-exact, output
within 2e-5, two calls bit-identical).  #5 (the KV row writer) takes a
layer's update as the composed path gives it (V a strided slice of the
fused qkv, int64 starts; q8: codes and both scale planes in one call) at
the batched cache, the engine's (bf16 and q8), tiny_real's heads and
deepseek_v2_lite's latent rows (one head of 640 at B 16 S 2048, bf16 and
q8): bit for bit against the plain assignment (int32 starts too, a start out of
range skipped, the one-array form), one call the writer's kernel alone
in a profiler trace and in a CUDA graph of it,
timed in graphs of 20 calls beside one index_put_ per array.  #7 and #8
are timed at the decode paths' shapes (the flagship engine's B 32 S 2048
without and with a 512-row window, beside the times before head groups,
the batched cache B 32 S 184, bench-sweep's tg at B 1 and 32, tiny_real's heads, OuteTTS's
cache at its prefill's rows and full, falcon-7b's and starcoder's engines
at 71 and 48 heads over one, G 3 at hd 256, hd / hdv 128 / 256 and 256 /
128, hd 512) with the tensors the model's layer hands them, beside
scaled_dot_product_attention, each with its plan (rows per block, head
groups), the host's eager dispatch of one call, and the device kernels
one call runs: the attention kernel alone, or the phase fails.  The
untimed checks of #7 / #8 include head groups (G 71, 7 and 3) and hdv !=
hd at the edge starts with large values in the rows a slot does not see.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import random
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth, int8 tensor rate and
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Device ms per call of ``fn`` from CUDA events.  With ``graph`` the
    ``iters`` calls are captured in one CUDA graph and replayed, so the time
    is the device's alone (a small kernel launched from Python otherwise
    measures the host's dispatch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def library_ms(fn, iters: int = 20) -> float | None:
    """Time of the one-call library yardstick, or None where this PyTorch
    build refuses the call (it is a comparison, not part of the port)."""
    try:
        return cuda_ms(fn, iters=iters, graph=True)
    except RuntimeError as e:
        print(f"library call unavailable: {e}", file=sys.stderr, flush=True)
        return None


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Rotation:
    """Copies of a weight whose total exceeds the 50 MB L2 cache, cycled so
    every timed call reads its weight from device memory, as a decode step
    does."""

    def __init__(self, t, min_total: int = 128 << 20):
        n = max(1, math.ceil(min_total / max(1, t.numel() * t.element_size())))
        self.copies = [t] + [t.clone() for _ in range(n - 1)]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]


INT_MM_ROW = "torch._int_mm, weight row-major"
INT_MM_COL = "torch._int_mm, weight column-major"
FP16_MM = "float16 torch.matmul"


def gemm_yardsticks(xq, w8, rotate: bool = True,
                    iters: int = 20) -> tuple[float | None, str | None, dict]:
    """The library yardsticks of an int8 GEMM on the unpacked int8 trits
    (weights rotated past the L2 with ``rotate``): ``torch._int_mm`` with
    the weight row-major and column-major (cuBLASLt's int8 layout), and one
    float16 matmul (codes and trits are exact in float16, every sum below
    2**24: the same integer product).  Returns the fastest's ms and name,
    and every time."""
    import torch

    total = 128 << 20 if rotate else 0
    times = {}
    for name, w in ((INT_MM_ROW, w8), (INT_MM_COL, w8.t().contiguous().t())):
        wr = Rotation(w, total)
        times[name] = library_ms(lambda: torch._int_mm(xq, wr.next()),
                                 iters=iters)
        del wr
    xh = xq.to(torch.float16)
    wr = Rotation(w8.to(torch.float16), total)
    times[FP16_MM] = library_ms(lambda: torch.matmul(xh, wr.next()),
                                iters=iters)
    del wr
    return (*fastest(times), times)


def fastest(times: dict, names=None) -> tuple[float | None, str | None]:
    """The least time of ``times`` (of ``names`` only, where given), with
    its name; (None, None) where none was timed."""
    timed = {k: v for k, v in times.items()
             if v is not None and (names is None or k in names)}
    best = min(timed, key=timed.get) if timed else None
    return timed.get(best), best


def check_float_prologue(name, got, want, codes_k, codes_r, xs_k, xs_r):
    """#1/#4's float prologue against its kernel-order emulation
    (``ops/ternary_gemm.py:decode_input_kernel_order``): codes, scales and
    the output bit for bit."""
    import torch

    if not torch.equal(codes_k, codes_r):
        d = (codes_k.int() - codes_r.int()).abs()
        fail(f"{name}: prologue codes differ from the kernel-order "
             f"reference (max {int(d.max())}, {int((d > 0).sum())} codes)")
    if not torch.equal(xs_k.reshape(-1), xs_r.reshape(-1)):
        fail(f"{name}: prologue scales differ from the kernel-order "
             "reference")
    err = float((got.float() - want.float()).abs().max())
    if err != 0.0:
        fail(f"{name}: kernel vs the kernel-order reference ({err})")
    return err


def decode_parts_ms(x1, rot, ws, kw) -> dict:
    """#1's (or #4's) prologue and GEMM timed apart, each in a CUDA graph of
    20 calls: the GEMM on the prologue's output; with a split of K, its
    workspace is zeroed by a fill kernel per call (the prologue's work in a
    call), timed apart and taken off."""
    from vlut_tpu_torch.ops import ternary_gemm as tg
    from vlut_tpu_torch.ops.packing import TRITS_PER_BYTE

    fmt, m, np_ = kw["fmt"], x1.shape[0], rot.copies[0].shape[1]
    kp = rot.copies[0].shape[0] * TRITS_PER_BYTE[fmt]
    args = (x1, kw["x2"], kw["norm_g"], kw["mode"], kw["sub_norm"],
            kw["norm_n"], kw["eps"], kp)
    pro_ms = cuda_ms(lambda: tg._launch_prologue(*args), graph=True)
    bn, splits = tg.decode_plan(m, np_, kp, fmt,
                                tg.sm_count(x1.device.index or 0))
    codes, xs, rowsum, work = tg._launch_prologue(*args, np_, bn, splits)
    od, res = kw["out_dtype"], kw["residual"]
    res = res.to(od).contiguous() if res is not None else None

    def gemm():
        if work is not None:
            work.zero_()
        return tg._launch_decode_gemm(codes, xs, rowsum, work, rot.next(), ws,
                                      fmt, m, res, od, bn, splits)
    gemm_ms = cuda_ms(gemm, graph=True)
    memset_ms = cuda_ms(work.zero_, graph=True) if work is not None else 0.0
    return {"prologue_ms": pro_ms, "gemm_ms": gemm_ms - memset_ms,
            "memset_ms": memset_ms, "plan": [bn, splits]}


def device_kernels(fn, capture: bool = True) -> list[str]:
    """The names of the device kernels (and memsets, copies) that one call
    of ``fn`` runs, from torch.profiler.  A trace without any device event
    is the profiler's miss, not a call that launched nothing (seen for the
    1.5 us KV row writer, whose output its caller had checked, twice, the
    second time in three traces running): it is taken again, at most
    twice, and then one call is read from a CUDA graph instead
    (:func:`graph_kernels`; ``capture`` False for a call that a graph
    cannot hold)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    if not capture:
        return names
    print("device_kernels: three profiler traces without a device event; "
          "reading the call from a CUDA graph", file=sys.stderr, flush=True)
    return graph_kernels(fn)


def graph_kernels(fn) -> list[str]:
    """The nodes that one call of ``fn`` puts in a CUDA graph, in order:
    a kernel by its (mangled) name, any other node by its type (MEMCPY,
    MEMSET, ...), read from the graph's debug dump (``BUILD_DIR``)."""
    import re
    import warnings

    import torch

    from vlut_tpu_torch.ops import _build

    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    path = _build.BUILD_DIR / "device_kernels.dot"
    path.parent.mkdir(parents=True, exist_ok=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the dump's own DEBUG notes
        g.debug_dump(str(path))
    text = path.read_text()
    path.unlink()
    del g
    nodes = []
    for node in re.split(r'"graph_\d+_node_\d+"\[', text)[1:]:
        kind = re.search(r'label="\{\s*(\w+)', node)
        name = re.search(r"ID \| (\d+) \(topoId: \d+\) \| ([^\s\\]+)", node)
        if kind is None:
            fail(f"graph_kernels: a node the dump reader does not know: "
                 f"{node[:200]!r}")
        if kind.group(1) == "KERNEL" and name is not None:
            nodes.append((int(name.group(1)), name.group(2)))
        else:
            ident = re.search(r"\{(\d+) \(topoId: \d+\)", node)
            nodes.append((int(ident.group(1)) if ident else len(nodes),
                          kind.group(1)))
    return [name for _, name in sorted(nodes)]


def check_two_kernels(name, launched) -> None:
    """A call of #1 or #4 runs exactly its prologue, then its GEMM: no
    memset, copy or other kernel (a split's workspace is the prologue's to
    zero)."""
    want = ("decode_prologue_kernel", "decode_gemm_kernel")
    if (len(launched) != 2
            or not all(w in e for w, e in zip(want, launched))):
        fail(f"{name}: one call ran {launched}, not {list(want)}")


def phase_kernels(dev, seed: int | None = None) -> dict:
    """Phase 2; ``seed`` (drawn from the OS when None, and printed) seeds
    the inputs and the order of the untimed checks."""
    import torch

    from vlut_tpu_torch.ops import kv_update, ternary_gemm as tg
    from vlut_tpu_torch.ops.quant import quantize_activations
    from vlut_tpu_torch.ops.packing import (
        TRITS_PER_BYTE, DEFAULT_BLOCK, padded_k, random_packed_bytes,
        unpack_fields)

    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    print(json.dumps({"phase": "kernels", "seed": seed}), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = {}
    sms = tg.sm_count(dev.index or 0)

    def rand_packed(k, n, fmt):
        return random_packed_bytes(
            (padded_k(k, fmt) // TRITS_PER_BYTE[fmt], n), fmt, gen, dev)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def trits_i8(packed, fmt, k):
        return (unpack_fields(packed, fmt, DEFAULT_BLOCK[fmt])[:k]
                .to(torch.int8) - 1).contiguous()

    def record(name, **kw):
        agg = results.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "library_ms": 0.0,
                                        "max_abs_err": 0.0, "shapes": []})
        for key in ("ms", "plain_ms", "bound_ms"):
            agg[key] += kw[key]
        agg["library_ms"] = (None if kw["library_ms"] is None
                             or agg["library_ms"] is None
                             else agg["library_ms"] + kw["library_ms"])
        agg["max_abs_err"] = max(agg["max_abs_err"], kw["max_abs_err"])
        agg["bound_by"] = kw["bound_by"]
        agg["shapes"].append(kw["shape"])
        print(json.dumps({"phase": "kernels", "kernel": name, **kw}),
              flush=True)

    def decode_case(label, m, k, n, mode, sub, has_res, fmt, plan=None):
        """#1's inputs at one projection, held against its plain version
        (with ``plan``, the kernels forced to that (BN, splits)); returns
        the inputs, the call's keywords and the largest error."""
        np_ = -(-n // 128) * 128  # the residual stays n wide
        packed = rand_packed(k, np_, fmt)
        ws = torch.full((np_,), 0.05, device=dev)
        if mode == "plain":
            x1 = randn(m, k, dtype=torch.float32)
        elif mode == "silu_mul":
            gu = randn(m, 2 * k)
            x1 = gu[:, :k]
        else:
            x1 = randn(m, k)
        kw = dict(x2=gu[:, k:] if mode == "silu_mul" else None,
                  norm_g=(torch.rand(k, generator=gen, device=dev) + 0.5
                          if mode == "norm" or sub else None),
                  residual=randn(m, n) if has_res else None, fmt=fmt,
                  kb=DEFAULT_BLOCK[fmt], k=k, mode=mode, sub_norm=sub,
                  norm_n=k, eps=1e-5, out_dtype=torch.bfloat16)
        x2, g, res = kw["x2"], kw["norm_g"], kw["residual"]
        if plan is None:
            got = tg.ternary_gemm_decode(x1, packed, ws, **kw)
        else:
            got = tg._decode_cuda(x1, packed, ws, x2, g, res, fmt,
                                  DEFAULT_BLOCK[fmt], mode, sub, k, 1e-5,
                                  torch.bfloat16, plan=plan)
        kp = packed.shape[0] * TRITS_PER_BYTE[fmt]
        xq_p, xs_p = tg.kernel_quantize(tg.decode_input_kernel_order(
            x1, x2, g, mode, sub, k, 1e-5, kp))
        want = tg._gemm_plain(xq_p, xs_p, packed, ws, fmt, DEFAULT_BLOCK[fmt],
                              k, res, torch.bfloat16)
        torch.cuda.synchronize()
        if mode == "plain":
            err = float((got.float() - want.float()).abs().max())
            if err != 0.0:
                fail(f"decode {label}: integer path differs ({err})")
        else:
            codes_k, xs_k = tg.prologue_codes(x1, x2, g, mode, sub, k, 1e-5,
                                              kp)
            err = check_float_prologue(f"decode {label}", got, want, codes_k,
                                       xq_p, xs_k, xs_p)
        return x1, packed, ws, kw, xq_p, err

    def tiled_case(label, m, k, n, fmt):
        """#3's inputs at one shape, bit-exact against its plain version."""
        kb = DEFAULT_BLOCK[fmt]
        packed = rand_packed(k, n, fmt)
        ws = torch.full((n,), 0.05, device=dev)
        xq, xs = quantize_activations(randn(m, k))
        got = tg.ternary_gemm_tiled(xq, packed, xs, ws, fmt=fmt, kb=kb, k=k)
        want = tg._gemm_plain(xq, xs, packed, ws, fmt, kb, k, None,
                              torch.float32)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"tiled {label}: differs ({err})")
        return packed, ws, xq, xs, err

    def fused_quant_case(label, m, k, n):
        """#4's inputs at one shape, bit-exact against its plain version."""
        packed = rand_packed(k, n, "i2")
        ws = torch.full((n,), 0.05, device=dev)
        x = randn(m, k)
        got = tg.ternary_gemm_fused_quant(x, packed, ws, fmt="i2", kb=128, k=k)
        xq, xs = tg.kernel_quantize(x)
        want = tg._gemm_plain(xq, xs, packed, ws, "i2", 128, k, None,
                              torch.float32)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"fused_quant {label}: differs ({err})")
        return packed, ws, x, xq, err

    # --- #1 fused decode projection: one decode layer of the flagship -------
    m = 32
    # (label, K, N, mode, sub_norm, residual?, fmt, in the flagship layer?)
    shapes = [
        ("qkv", 4096, 6144, "norm", False, False, "i2", True),
        ("wo", 4096, 4096, "plain", False, True, "i2", True),
        ("gateup", 4096, 28672, "norm", False, False, "i2", True),
        ("down", 14336, 4096, "silu_mul", False, True, "i2", True),
        ("qkv_i1", 4096, 6144, "norm", False, False, "i1", False),
        ("down_subnorm", 14336, 4096, "silu_mul", True, True, "i2", False),
    ]
    for label, k, n, mode, sub, has_res, fmt, main_path in shapes:
        x1, packed, ws, kw, xq_p, err = decode_case(label, m, k, n, mode, sub,
                                                    has_res, fmt)
        x2, g, res, od = (kw["x2"], kw["norm_g"], kw["residual"],
                          kw["out_dtype"])
        rot = Rotation(packed)
        ms = cuda_ms(lambda: tg.ternary_gemm_decode(x1, rot.next(), ws, **kw),
                     graph=True)
        # the same calls launched one by one from Python: the host's
        # dispatch per call, which bounds a decode step that is not graphed
        eager_ms = cuda_ms(lambda: tg.ternary_gemm_decode(x1, rot.next(), ws,
                                                          **kw))
        parts = decode_parts_ms(x1, rot, ws, kw)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.decode_prologue(x1, x2, g, mode, sub, k, 1e-5), packed, ws,
            fmt, DEFAULT_BLOCK[fmt], k, res, od), iters=3, warmup=1)
        lib_ms, lib_name, yard = gemm_yardsticks(xq_p, trits_i8(packed, fmt, k))
        in_b = x1.element_size() * m * k * (2 if x2 is not None else 1)
        nbytes = (in_b + packed.numel() + 4 * n + (4 * k if g is not None else 0)
                  + (2 * m * n if res is not None else 0) + 2 * m * n)
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        name = ("ternary_gemm_decode" if main_path
                else "ternary_gemm_decode_other")
        record(name, shape=f"{label} M={m} {k}->{n} {fmt} {mode}"
               f"{'+sub' if sub else ''}{'+res' if has_res else ''}",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, eager_ms=eager_ms,
               library=lib_name, yardsticks_ms=yard, **parts)
        if label in ("wo", "gateup"):  # with a split of K, and without
            launched = device_kernels(
                lambda: tg.ternary_gemm_decode(x1, packed, ws, **kw))
            print(json.dumps({"phase": "kernels_per_call",
                              "kernel": "ternary_gemm_decode",
                              "shape": label, "plan": parts["plan"],
                              "device_kernels": launched}), flush=True)
            check_two_kernels(f"decode {label}", launched)
        del rot

    # --- #4 fused-quant GEMM: the unfused tree's projections at M = 32 ------
    unfused = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
               ("w_gate", 4096, 14336), ("w_up", 4096, 14336),
               ("w_down", 14336, 4096))
    for label, k, n in unfused:
        packed, ws, x, xq, err = fused_quant_case(label, m, k, n)
        rot = Rotation(packed)
        ms = cuda_ms(lambda: tg.ternary_gemm_fused_quant(
            x, rot.next(), ws, fmt="i2", kb=128, k=k), graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.kernel_quantize(x), packed, ws, "i2", 128, k, None,
            torch.float32), iters=3, warmup=1)
        lib_ms, lib_name, yard = gemm_yardsticks(xq, trits_i8(packed, "i2", k))
        parts = decode_parts_ms(x, rot, ws, dict(
            x2=None, norm_g=None, residual=None, fmt="i2", mode="plain",
            sub_norm=False, norm_n=0, eps=0.0, out_dtype=torch.float32))
        nbytes = 2 * m * k + packed.numel() + 4 * n + 4 * m * n
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record("ternary_gemm_fused_quant", shape=f"{label} M={m} {k}->{n} i2",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, library=lib_name,
               yardsticks_ms=yard, **parts)
        if label == "w_down":
            launched = device_kernels(lambda: tg.ternary_gemm_fused_quant(
                x, packed, ws, fmt="i2", kb=128, k=k))
            print(json.dumps({"phase": "kernels_per_call",
                              "kernel": "ternary_gemm_fused_quant",
                              "shape": label, "device_kernels": launched}),
                  flush=True)
            check_two_kernels(f"fused_quant {label}", launched)
        del rot

    # --- #3 tiled GEMM: the flagship prefill's projections at M = 4096, then
    # the microbenchmark's i2 lanes (llama3_8b dxd, dxff, ffxd at M 32 and
    # 256, weights rotated past the L2 as the bench does) --------------------
    def tiled_timed(name, label, m, k, n, fmt, iters, rotate):
        kb = DEFAULT_BLOCK[fmt]
        packed, ws, xq, xs, err = tiled_case(label, m, k, n, fmt)
        rot = Rotation(packed, 128 << 20 if rotate else 0)
        ms = cuda_ms(lambda: tg.ternary_gemm_tiled(
            xq, rot.next(), xs, ws, fmt=fmt, kb=kb, k=k), iters=iters,
            graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            xq, xs, packed, ws, fmt, kb, k, None, torch.float32),
            iters=2, warmup=1)
        # the yardsticks; the library time is the faster _int_mm layout
        yard = gemm_yardsticks(xq, trits_i8(packed, fmt, k), rotate,
                               iters)[2]
        lib_ms, lib_name = fastest(yard, (INT_MM_ROW, INT_MM_COL))
        nbytes = m * k + 4 * m + packed.numel() + 4 * n + 4 * m * n
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record(name, shape=f"{label} M={m} {k}->{n} {fmt}", ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, library=lib_name,
               yardsticks_ms=yard,
               plan=tg.tiled_plan(m, packed.shape[1],
                                  packed.shape[0] * TRITS_PER_BYTE[fmt], fmt,
                                  sms))
        del rot
        torch.cuda.empty_cache()

    for label, k, n, fmt in (("qkv", 4096, 6144, "i2"),
                             ("wo", 4096, 4096, "i2"),
                             ("gateup", 4096, 28672, "i2"),
                             ("down", 14336, 4096, "i2"),
                             ("qkv_i1", 4096, 6144, "i1")):
        tiled_timed("ternary_gemm_tiled" if fmt == "i2"
                    else "ternary_gemm_tiled_other", label, 4096, k, n, fmt,
                    iters=5, rotate=False)
    for label, k, n in (("dxd", 4096, 4096), ("dxff", 4096, 14336),
                        ("ffxd", 14336, 4096)):
        for m in (32, 256):
            tiled_timed("ternary_gemm_tiled_lanes", label, m, k, n, "i2",
                        iters=20, rotate=True)

    # --- the flagship's tp-2 shards (phase 29): #4 at the column shards
    # (wq, wk, wv, w_gate, w_up: N halved) at the decode's M 32, and #3 with
    # unit scales at the row shards (wo, w_down: K halved) at M 32 and 4096,
    # whose float32 output is then the int32 accumulator the ranks sum
    for label, k, n in (("wq", 4096, 2048), ("wk", 4096, 512),
                        ("wv", 4096, 512), ("w_gate", 4096, 7168),
                        ("w_up", 4096, 7168)):
        packed, ws, x, xq, err = fused_quant_case(f"{label}_tp2", 32, k, n)
        rot = Rotation(packed)
        ms = cuda_ms(lambda: tg.ternary_gemm_fused_quant(
            x, rot.next(), ws, fmt="i2", kb=128, k=k), graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.kernel_quantize(x), packed, ws, "i2", 128, k, None,
            torch.float32), iters=3, warmup=1)
        lib_ms, lib_name, yard = gemm_yardsticks(xq, trits_i8(packed, "i2", k))
        nbytes = 2 * 32 * k + packed.numel() + 4 * n + 4 * 32 * n
        b_ms, by = bound_ms(nbytes, 2 * 32 * k * n)
        record("ternary_gemm_fused_quant_tp2",
               shape=f"{label} tp2 M=32 {k}->{n} i2", ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, library=lib_name,
               yardsticks_ms=yard)
        del rot
    for label, k, n in (("wo", 2048, 4096), ("w_down", 7168, 4096)):
        for m_rows in (32, 4096):
            packed = rand_packed(k, n, "i2")
            xq, _ = quantize_activations(randn(m_rows, k))
            ones_x = torch.ones((m_rows, 1), device=dev)
            ones_w = torch.ones((n,), device=dev)
            got = tg.ternary_gemm_tiled(xq, packed, ones_x, ones_w, fmt="i2",
                                        kb=128, k=k)
            want = tg._gemm_plain(xq, ones_x, packed, ones_w, "i2", 128, k,
                                  None, torch.float32)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or not torch.equal(got, got.round()):
                fail(f"tiled {label} tp2 M={m_rows}: the unit-scale output "
                     f"is not the integer accumulator ({err})")
            rot = Rotation(packed)
            ms = cuda_ms(lambda: tg.ternary_gemm_tiled(
                xq, rot.next(), ones_x, ones_w, fmt="i2", kb=128, k=k),
                iters=5 if m_rows > 64 else 20, graph=True)
            plain_ms = cuda_ms(lambda: tg._gemm_plain(
                xq, ones_x, packed, ones_w, "i2", 128, k, None,
                torch.float32), iters=2, warmup=1)
            yard = gemm_yardsticks(xq, trits_i8(packed, "i2", k))[2]
            lib_ms, lib_name = fastest(yard, (INT_MM_ROW, INT_MM_COL))
            nbytes = m_rows * k + 4 * m_rows + packed.numel() + 4 * n + (
                4 * m_rows * n)
            b_ms, by = bound_ms(nbytes, 2 * m_rows * k * n)
            record("ternary_gemm_tiled_tp2",
                   shape=f"{label} tp2 M={m_rows} {k}->{n} i2 unit scales",
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                   library_ms=lib_ms, max_abs_err=err, library=lib_name,
                   yardsticks_ms=yard,
                   plan=tg.tiled_plan(m_rows, n, k, "i2", sms))
            del rot
    torch.cuda.empty_cache()

    # --- the zoo presets' projections (phase 19) at their engines' decode
    # M (qwen3_4b 16 slots, gemma2_2b 8) through #1 or #4 as the JAX gates
    # send them, and at their prefill bucket (M 512) through #3
    def zoo_timed(label, k, n, mode, sub, has_res, fused, m):
        if fused:
            x1, packed, ws, kw, xq, err = decode_case(label, m, k, n, mode,
                                                      sub, has_res, "i2")
            if err != 0.0:
                fail(f"decode {label} M={m}: differs from the plain version "
                     f"({err})")
            rot = Rotation(packed)
            ms = cuda_ms(lambda: tg.ternary_gemm_decode(
                x1, rot.next(), ws, **kw), graph=True)
            plain_ms = cuda_ms(lambda: tg._gemm_plain(
                *tg.decode_prologue(x1, kw["x2"], kw["norm_g"], mode, sub, k,
                                    1e-5), packed, ws, "i2", 128, k,
                kw["residual"], kw["out_dtype"]), iters=3, warmup=1)
            in_b = x1.element_size() * m * k * (2 if kw["x2"] is not None
                                                 else 1)
            nbytes = (in_b + packed.numel() + 4 * n
                      + (4 * k if kw["norm_g"] is not None else 0)
                      + (2 * m * n if has_res else 0) + 2 * m * n)
            name, shape = "ternary_gemm_decode_zoo", f"{label} M={m} {mode}"
        else:
            packed, ws, x, xq, err = fused_quant_case(label, m, k, n)
            rot = Rotation(packed)
            ms = cuda_ms(lambda: tg.ternary_gemm_fused_quant(
                x, rot.next(), ws, fmt="i2", kb=128, k=k), graph=True)
            plain_ms = cuda_ms(lambda: tg._gemm_plain(
                *tg.kernel_quantize(x), packed, ws, "i2", 128, k, None,
                torch.float32), iters=3, warmup=1)
            nbytes = 2 * m * k + packed.numel() + 4 * n + 4 * m * n
            name, shape = "ternary_gemm_fused_quant_zoo", f"{label} M={m}"
        lib_ms, lib_name, yard = gemm_yardsticks(xq, trits_i8(packed, "i2", k))
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record(name, shape=f"{shape} {k}->{n} i2", ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
               max_abs_err=err, library=lib_name, yardsticks_ms=yard)
        del rot

    for proj in zoo_projections():
        zoo_timed(*proj, 8 if proj[0].startswith("gemma2") else 16)
    for label, k, n, *_ in zoo_projections():
        tiled_timed("ternary_gemm_tiled_zoo", label, 512, k, n, "i2",
                    iters=5, rotate=False)

    # --- #5/#6 KV row writer: a layer's update as the composed path gives it
    kv_kernels(dev, gen, record)
    decode_attention_kernels(dev, gen, record)
    # #7/#8 at qwen3_4b's engine (B 16, S 2048, 32/8 heads of 128) and at
    # a sliding layer of gemma2_2b's heads (8/4 of 256) with its 4,096-row
    # window past 5,000 rows (gemma2_2b itself decodes composed: its
    # softcap gate)
    decode_attention_kernels(dev, gen, record, (
        ("qwen3_4b", 16, 2048, 8, 4, 128, 128, 0, "spread"),
        ("hd256_w4096", 8, 8192, 4, 2, 256, 256, 4096, 5000)))
    # #7/#8 at a heterogeneous stack's narrower layer (phase 20's
    # hetero_heads: 2 query heads over 1 KV head in a model of 4 over 2,
    # the layer's cache holding its own head; mixtral_8x7b's 32/8 heads of
    # 128 at B 16 S 2048 are qwen3_4b's shape above)
    decode_attention_kernels(dev, gen, record, (
        ("hetero_hkv1", 4, 2048, 1, 2, 128, 128, 0, "spread"),))
    # #5, #7 and #8 at a tp-2 rank's share of the flagship engine (phase
    # 29): 4 of the 8 KV heads, 16 of the 32 query heads
    kv_kernels(dev, gen, record, (("tp2", 32, 2048, 4, False, 128),
                                  ("tp2_q8", 32, 2048, 4, True, 128)))
    decode_attention_kernels(dev, gen, record, (
        ("tp2", 32, 2048, 4, 4, 128, 128, 0, "spread"),))
    tq_kernels(dev, gen, record)

    # --- deepseek_v2_lite (phase 21), mamba_2_8b / codestral_mamba_7b
    # (phase 22) and llada_8b (phase 23), timed: the engines' decode M 16
    # (#1 / #4; llada's projections at M 32 through #1, the diffusion
    # families' short forwards) and their prefills' M (#3: 512, 1024, and
    # llada's denoise forward, M 256); #5 at V2-Lite's latent rows (one
    # head of 640; V a strided slice here, where the layer's own rows are
    # contiguous)
    for proj in v2_lite_projections():
        zoo_timed(*proj, 16)
    for label, k, n, *_ in v2_lite_projections():
        tiled_timed("ternary_gemm_tiled_zoo", label, 512, k, n, "i2",
                    iters=5, rotate=False)
    kv_kernels(dev, gen, record, (("mla_v2_lite", 16, 2048, 1, False, 640),
                                  ("mla_v2_lite_q8", 16, 2048, 1, True,
                                   640)))
    for proj in recurrent_projections():
        zoo_timed(*proj, 16)
    for label, k, n, *_ in recurrent_projections():
        tiled_timed("ternary_gemm_tiled_zoo", label, 1024, k, n, "i2",
                    iters=5, rotate=False)
    for proj in llada_projections():
        zoo_timed(*proj, 32)
    for label, k, n, *_, fused in llada_projections():
        if fused:
            tiled_timed("ternary_gemm_tiled_zoo", label, 256, k, n, "i2",
                        iters=5, rotate=False)
    # llava_1_5_7b (phase 26): the fused tree's four through #1 at the
    # decode's M 1, through #3 at the image-bearing prefill's M; #7 at its
    # cache (B 1, 32 heads over 32 KV heads of 128, G 1)
    m_img = llava_prefill_m()
    for proj in llava_projections():
        zoo_timed(*proj, 1)
    for label, k, n, *_ in llava_projections():
        tiled_timed("ternary_gemm_tiled_zoo", label, m_img, k, n, "i2",
                    iters=5, rotate=False)
    decode_attention_kernels(dev, gen, record, (
        ("llava_1_5_7b", 1, 1024, 32, 1, 128, 128, 0, m_img),))
    # the audio half (phase 27): the flagship's four through #3 at the
    # audio-bearing prefill's M (#1 / #7 at its decode are the flagship's
    # B 1 shapes, and #7 is timed at that cache here); outetts_0_2_500m's
    # seven at M 1 as its gates send them (#4; wo #1) and through #3 at its
    # prefill's M (a seeded speaker profile); #5 at its cache (one slot of
    # 8,192 rows, 2 KV heads of 64 padded to 128)
    from vlut_tpu_torch.bench import audio_zoo

    m_audio = audio_zoo.prefill_rows(ROOT / "tests" / "fixtures"
                                     / "tiny_real")
    for label, k, n, *_ in shapes[:4]:
        tiled_timed("ternary_gemm_tiled_zoo", f"audio_{label}",
                    m_audio["describe"], k, n, "i2", iters=5, rotate=False)
    decode_attention_kernels(dev, gen, record, (
        ("llama3_8b_audio", 1, 1024, 8, 4, 128, 128, 0,
         m_audio["describe"]),))
    for proj in audio_zoo.outetts_projections():
        zoo_timed(*proj, 1)
    for label, k, n, *_ in audio_zoo.outetts_projections():
        tiled_timed("ternary_gemm_tiled_zoo", label, m_audio["tts"], k, n,
                    "i2", iters=5, rotate=False)
    kv_kernels(dev, gen, record, (("outetts", 1, 8192, 2, False, 128),))

    # the card's autotune table (bench/autotune_h100.json; its lookups are
    # live where this card's name is the table's): #3 at each tile entry's
    # tiles against tiled_plan's at the entry's shape, device time per call,
    # printed (the sweep decided the entries; no gate here)
    from vlut_tpu_torch.bench import autotune

    table = autotune.load_table(dev.index or 0)
    print(json.dumps({"phase": "kernels_table", "live": bool(table),
                      "table_card": autotune._read(str(
                          autotune.TABLE_FILE)).get("card"),
                      "entries": len(table)}), flush=True)
    card = card_line()
    tile_entries = [(k, v) for k, v in sorted(table.items())
                    if not k.startswith("route:")]
    route_entries = [k for k in sorted(table) if k.startswith("route:")]
    for key, tiles in tile_entries:
        fmt, m, kp, np_ = key.split(":")
        m, kp, np_ = int(m), int(kp), int(np_)
        rot = Rotation(rand_packed(kp, np_, fmt))
        xq, xs = quantize_activations(randn(m, kp))
        ws = torch.full((np_,), 0.05, device=dev)
        plan = tg.tiled_plan(m, np_, kp, fmt, sms)
        us = {name: 1e3 * cuda_ms(lambda t=t: tg._tiled_cuda(
            xq, rot.next(), xs, ws, fmt, DEFAULT_BLOCK[fmt], kp,
            torch.float32, plan=tuple(t)), graph=True)
            for name, t in (("tiles", tiles), ("plan", plan), ("tiles2",
                                                               tiles))}
        print(json.dumps({"phase": "kernels_table", "key": key,
                          "tiles": tiles, "plan": plan,
                          "us_tiles": min(us["tiles"], us["tiles2"]),
                          "us_plan": us["plan"], "card": card}),
              flush=True)
        del rot
    torch.cuda.empty_cache()

    # --- the other paths' shapes, checked and not timed, in an order
    # shuffled by the phase's seed: no check may depend on the data an
    # earlier draw left the generator at --------------------------------
    def checked(name, shape, err):
        agg = results[name]
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg.setdefault("checked", []).append(shape)
        print(json.dumps({"phase": "kernels_check", "kernel": name,
                          "shape": shape, "max_abs_err": err}), flush=True)

    def exact(name, shape, err):
        checked(name, shape, err)
        if err != 0.0:
            fail(f"{name} {shape}: differs from its reference ({err})")

    jobs = []

    def job(fn, *args):
        jobs.append(lambda: fn(*args))

    # #1 in the e2e benches' decode (batch 1 and 32) and at M 17, 33 and
    # 64: every flagship projection, i2 and i1
    def decode_check(label, m, k, n, mode, sub, has_res, fmt, tag=""):
        err = decode_case(label, m, k, n, mode, sub, has_res, fmt)[-1]
        exact("ternary_gemm_decode", f"{tag}{label} M={m} {k}->{n} {fmt} "
              f"{mode}", err)

    for fmt in ("i2", "i1"):
        for m in (1, 17, 32, 33, 64):
            for label, k, n, mode, sub, has_res, _, _ in shapes[:4]:
                job(decode_check, label, m, k, n, mode, sub, has_res, fmt)

    # #1 bit-exact (plain mode, with a residual) at shapes that make
    # decode_plan take every kernel instantiation and split count, and with
    # every (BN, splits) forced at two of them
    forced = {(17, 3840, 512), (64, 3840, 384)}

    def plan_check(m, k, n, fmt):
        np_, kp = -(-n // 128) * 128, padded_k(k, fmt)
        plans = [None]
        if (m, k, n) in forced:
            plans += [(bn, sp) for bn in (128, 256) if np_ % bn == 0
                      for sp in range(1, min(kp // DEFAULT_BLOCK[fmt],
                                             tg.MAX_SPLITS) + 1)]
        for plan in plans:
            err = decode_case("plan", m, k, n, "plain", False, True, fmt,
                              plan)[-1]
            shown = plan or tg.decode_plan(m, np_, kp, fmt, sms)
            exact("ternary_gemm_decode", f"plan M={m} {k}->{n} {fmt} "
                  f"{'forced' if plan else 'plan'}={shown}", err)
        torch.cuda.empty_cache()

    for fmt in ("i2", "i1"):
        for m, k, n in tg.DECODE_PLAN_SHAPES:
            job(plan_check, m, k, n, fmt)

    def fused_quant_check(label, m, k, n, tag=""):
        err = fused_quant_case(label, m, k, n)[-1]
        exact("ternary_gemm_fused_quant", f"{tag}{label} M={m} {k}->{n} i2",
              err)

    # the server's embeddings of one and of three inputs (bucket 16: M 16
    # and 48) at the flagship's widths: #1 at each projection of the fused
    # tree, #4 at each of the unfused tree, i2
    for m in (16, 48):
        for label, k, n, mode, sub, has_res, _, _ in shapes[:4]:
            job(decode_check, label, m, k, n, mode, sub, has_res, "i2",
                "embed_")
        for label, k, n in unfused:
            job(fused_quant_check, label, m, k, n, "embed_")
    # #1 at the draft model's widths (bitnet_2b_4t: d 2560, 20/5 heads,
    # d_ff 6912, sub-norms) at M 32, each projection of its layer
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    dc = PRESETS["bitnet_2b_4t"]
    dp = make_plan(dc)
    for label, k, n, mode, sub, has_res in (
            ("draft_qkv", dc.d_model, dp.q_dim_p + 2 * dp.kv_dim_p, "norm",
             False, False),
            ("draft_wo", dp.wo_in_p, dc.d_model, "norm", False, True),
            ("draft_gateup", dc.d_model, 2 * dp.ff_p, "norm", False, False),
            ("draft_down", dp.ff_p, dc.d_model, "silu_mul", True, True)):
        job(decode_check, label, 32, k, n, mode, sub, has_res, "i2")
    # the zoo presets' projections (phase 19) at decode M 1, 32 and 64: #1
    # where the JAX gates fuse them (qwen3_4b all four, gemma2_2b qkv with
    # its (1 + w) gain), #4 where they do not (gemma2_2b wo, gate|up and
    # down, unfused by its post-norms and gelu)
    for label, k, n, mode, sub, has_res, m in zoo_decode_shapes():
        job(decode_check, label, m, k, n, mode, sub, has_res, "i2")
    for label, k, n, m in zoo_fused_quant_shapes():
        job(fused_quant_check, label, m, k, n)

    # #3 in the microbenchmark's i2/i1 lanes (llama3_8b dxd, dxff, ffxd at
    # M 32 and 256) and in the e2e benches' prefills (pp 512 at batch 1 and
    # 32: M 512 and 16384)
    lanes = [(tag, m, k, n) for tag, k, n in (("dxd", 4096, 4096),
                                              ("dxff", 4096, 14336),
                                              ("ffxd", 14336, 4096))
             for m in (32, 256)]
    lanes += [(label, m, k, n) for label, k, n, *_ in shapes[:4]
              for m in (512, 16384)]
    # the speculative verify (32 slots x (k 4 + 1): M 160) and the
    # lookahead round (32 slots x T 11: M 352) at the flagship's widths
    lanes += [(f"{tag}_{label}", m, k, n) for label, k, n, *_ in shapes[:4]
              for tag, m in (("verify", 160), ("lookahead", 352))]
    # the server's rerank of 32 documents in a 256 bucket (M 8192)
    lanes += [(f"rerank_{label}", 8192, k, n)
              for label, k, n, *_ in shapes[:4]]
    # and at shapes that make tiled_plan take each of its tile rows (32, 64,
    # 128) with and without a split of K, at a ragged K too
    lanes += [("plan", m, k, n) for m, k, n in (
        (1, 1280, 384), (20, 4096, 28672), (65, 1280, 384),
        (200, 4096, 28672), (513, 1280, 384), (300, 4096, 28672),
        (65, 1283, 384), (256, 3000, 640))]

    def tiled_check(label, m, k, n, fmt):
        err = tiled_case(label, m, k, n, fmt)[-1]
        plan = tg.tiles(m, -(-n // 128) * 128, padded_k(k, fmt), fmt,
                        dev.index or 0)
        exact("ternary_gemm_tiled", f"{label} M={m} {k}->{n} {fmt} "
              f"plan={plan}", err)
        torch.cuda.empty_cache()

    # the autotune table: #3 bit-exact at every tile entry's tiles at its
    # key's shape; ternary_matmul's two routes (#4, and the same int8
    # quantization then #3) array-equal at each route entry, or, where the
    # table has none, at the route sweep's shapes at M 1 and 64
    def table_tiles_check(key, tiles):
        fmt, m, kp, np_ = key.split(":")
        m, kp, np_ = int(m), int(kp), int(np_)
        kb = DEFAULT_BLOCK[fmt]
        packed = rand_packed(kp, np_, fmt)
        ws = torch.rand(np_, generator=gen, device=dev) * 0.1 + 0.01
        xq, xs = quantize_activations(randn(m, kp))
        got = tg._tiled_cuda(xq, packed, xs, ws, fmt, kb, kp, torch.float32,
                             plan=tuple(tiles))
        want = tg._gemm_plain(xq, xs, packed, ws, fmt, kb, kp, None,
                              torch.float32)
        exact("ternary_gemm_tiled", f"table {key} tiles={tiles}",
              float((got - want).abs().max()))

    def route_check(fmt, m, kp, np_):
        kb = DEFAULT_BLOCK[fmt]
        packed = rand_packed(kp, np_, fmt)
        ws = torch.rand(np_, generator=gen, device=dev) * 0.1 + 0.01
        x = randn(m, kp)
        small = tg.ternary_gemm_fused_quant(x, packed, ws, fmt=fmt, kb=kb,
                                            k=kp)
        xq, xs = tg.kernel_quantize(x)
        tiled = tg.ternary_gemm_tiled(xq, packed, xs, ws, fmt=fmt, kb=kb,
                                      k=kp)
        same = torch.equal(small, tiled)
        exact("ternary_gemm_tiled", f"route M={m} {kp}->{np_} {fmt}: small "
              "= tiled", 0.0 if same else float((small - tiled).abs().max())
              or math.inf)

    for key, tiles in tile_entries:
        job(table_tiles_check, key, tiles)
    routes = [tuple(int(v) if v.isdigit() else v for v in key.split(":")[1:])
              for key in route_entries] or [
        (fmt, m, padded_k(k, fmt), -(-n // 128) * 128)
        for fmt in ("i2", "i1") for _, k, n in autotune.ROUTE_SHAPES
        for m in (1, 64)]
    for fmt, m, kp, np_ in routes:
        job(route_check, fmt, m, kp, np_)

    # the zoo presets' prefills (phase 19: chunks of 1024 rows and a group
    # of 4096; the 512 bucket is timed above) at each projection, in their
    # format (i2)
    for fmt in ("i2", "i1"):
        for label, m, k, n in lanes + (zoo_prefill_lanes() if fmt == "i2"
                                       else []):
            job(tiled_check, label, m, k, n, fmt)
    # #9 bit-exact at shapes that make tq_plan take each of its tiles and
    # split counts (ragged M and N, bk 256 to 2048), and with every tile and
    # split forced at two shapes
    job(tq_checks, dev, gen, checked)

    # #7 in the e2e benches' decode: bench_sweep's tg from an empty cache
    # (S 552) at batch 1 and 32, batched_bench's after a 128-token prefill
    def attention_check(b, s, first):
        err = attention_case(dev, gen, b, s, first)
        checked("decode_attention", f"B={b} S={s} start={first}+", err)

    for b, s, first in ((1, 552, 0), (1, 552, 31), (32, 552, 0),
                        (32, 168, 128)):
        job(attention_check, b, s, first)

    # #7 and #8 at shapes that make attn_plan take each rows-per-block choice
    # (every choice forced at two), at the edge starts (0, S - 1, out of
    # range) with large finite values in the rows a slot does not see, at
    # B 1, and replayed from a CUDA graph: cache bit-exact, output within
    # 2e-5, two calls bit-identical
    def attention_study_checks():
        from vlut_tpu_torch.bench import attention_study

        for r in attention_study.check(gen):
            name = ("decode_attention_int8" if "q8=True" in r["label"]
                    else "decode_attention")
            if r["why"]:
                fail(f"{name} {r['label']} rows={r['rows']}: {r['why']}")
            checked(name, f"{r['label']} rows={r['rows']}", r["max_abs_err"])

    job(attention_study_checks)

    # deepseek_v2_lite (phase 21): #1 / #4 at M 1, 32 and 64, #3 at M 1024
    # and 4096; mamba_2_8b's and codestral_mamba_7b's in_proj / out_proj
    # (phase 22): #4 at M 1, 16 and 64, #3 at the prefills' M (Mamba-2.8B's
    # groups of 1024 and 4096 rows, Codestral's 128-token generate prompt
    # and 1024); llada_8b (phase 23): #1 at M 1, 32 and 64 (the fused
    # tree's four, float prologues against the kernel-order reference), #3
    # at M 256 and 1024
    for label, k, n, mode, sub, has_res, fused in v2_lite_projections():
        for m in (1, 32, 64):
            if fused:
                job(decode_check, label, m, k, n, mode, sub, has_res, "i2")
            else:
                job(fused_quant_check, label, m, k, n)
        for m in (1024, 4096):
            job(tiled_check, label, m, k, n, "i2")
    for label, k, n, *_ in recurrent_projections():
        for m in (1, 16, 64):
            job(fused_quant_check, label, m, k, n)
        for m in ((1024, 4096) if label.startswith("mamba") else (128, 1024)):
            job(tiled_check, label, m, k, n, "i2")
    for label, k, n, mode, sub, has_res, fused in llada_projections():
        for m in (1, 32, 64):
            if fused:
                job(decode_check, label, m, k, n, mode, sub, has_res, "i2")
            else:
                job(fused_quant_check, label, m, k, n)
        if fused:
            for m in (256, 1024):
                job(tiled_check, label, m, k, n, "i2")

    # llava_1_5_7b (phase 26): #1 at M 1 and 32, #3 at the prefill's M and
    # at M 1024
    for label, k, n, mode, sub, has_res, fused in llava_projections():
        for m in (1, 32):
            job(decode_check, label, m, k, n, mode, sub, has_res, "i2")
        for m in (m_img, 1024):
            job(tiled_check, label, m, k, n, "i2")
    # the audio half (phase 27): the flagship's four through #1 at M 1 and
    # #3 at the describe prefill's M; outetts_0_2_500m's seven at M 1, 32
    # and 64 (#1 / #4) and through #3 at its prefill's M and at M 1024
    for label, k, n, mode, sub, has_res, _, _ in shapes[:4]:
        job(decode_check, label, 1, k, n, mode, sub, has_res, "i2",
            "audio_")
        job(tiled_check, f"audio_{label}", m_audio["describe"], k, n, "i2")
    for label, k, n, mode, sub, has_res, fused in (
            audio_zoo.outetts_projections()):
        for m in (1, 32, 64):
            if fused:
                job(decode_check, label, m, k, n, mode, sub, has_res, "i2")
            else:
                job(fused_quant_check, label, m, k, n)
        for m in (m_audio["tts"], 1024):
            job(tiled_check, label, m, k, n, "i2")

    order = list(range(len(jobs)))
    random.Random(seed).shuffle(order)
    print(json.dumps({"phase": "kernels_checks", "seed": seed,
                      "jobs": len(jobs), "order": order}), flush=True)
    for i in order:
        jobs[i]()
        torch.cuda.empty_cache()
    return results


def zoo_projections() -> list:
    """(label, K, N, mode, sub_norm, residual?, fused?) of each projection
    of the zoo presets' serving trees, by the JAX gates: qwen3_4b fuses all
    four (#1); gemma2_2b fuses qkv (#1, norm with the gain 1 + w) and runs
    wo, gate|up and down unfused (#4); mixtral_8x7b (phase 20) fuses qkv
    and wo (#1) and runs each expert's gate and up (4096 -> 14336) and down
    (14336 -> 4096) through #4, its gate and up apart (a MoE model's gate|up
    does not fuse)."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    c = PRESETS["mixtral_8x7b"]
    p = make_plan(c)
    out = [
        ("mixtral_8x7b_qkv", c.d_model, p.q_dim_p + 2 * p.kv_dim_p, "norm",
         False, False, True),
        ("mixtral_8x7b_wo", p.wo_in_p, c.d_model, "plain", False, True, True),
        ("mixtral_8x7b_expert_gate", c.d_model, p.ff_p, "plain", False,
         False, False),
        ("mixtral_8x7b_expert_down", p.ff_p, c.d_model, "plain", False,
         False, False),
    ]
    for name in ("qwen3_4b", "gemma2_2b"):
        c = PRESETS[name]
        p = make_plan(c)
        fused = name == "qwen3_4b"
        out += [
            (f"{name}_qkv", c.d_model, p.q_dim_p + 2 * p.kv_dim_p, "norm",
             False, False, True),
            (f"{name}_wo", p.wo_in_p, c.d_model, "plain", False, True, fused),
            (f"{name}_gateup", c.d_model, 2 * p.ff_p, "norm", False, False,
             fused),
            (f"{name}_down", p.ff_p, c.d_model, "silu_mul", False, True,
             fused),
        ]
    return out


def llada_projections() -> list:
    """As :func:`zoo_projections`, llada_8b's (phase 23) fused tree: qkv
    (4096 -> 12288, norm), wo (plain, residual), gate|up (4096 -> 24576,
    norm) and down (12288 -> 4096, silu_mul, residual) through #1 at M <=
    64, #3 above; and the unfused tree a checkpoint loads as (the JAX
    package's denoise loop takes it as it is): wq, w_gate and w_down
    through #4 at M <= 64."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    c = PRESETS["llada_8b"]
    p = make_plan(c)
    return [
        ("llada_8b_qkv", c.d_model, p.q_dim_p + 2 * p.kv_dim_p, "norm",
         False, False, True),
        ("llada_8b_wo", p.wo_in_p, c.d_model, "plain", False, True, True),
        ("llada_8b_gateup", c.d_model, 2 * p.ff_p, "norm", False, False,
         True),
        ("llada_8b_down", p.ff_p, c.d_model, "silu_mul", False, True, True),
        ("llada_8b_unfused_wq", c.d_model, p.q_dim_p, "plain", False, False,
         False),
        ("llada_8b_unfused_w_gate", c.d_model, p.ff_p, "plain", False,
         False, False),
        ("llada_8b_unfused_w_down", p.ff_p, c.d_model, "plain", False,
         False, False),
    ]


# the prompt phase 26 describes its image with (tiny_real's tokenizer)
LLAVA_PROMPT = "USER: <image>\nDescribe the image. ASSISTANT:"


def llava_prefill_m() -> int:
    """Rows of phase 26's prefill: the prompt's text tokens (tiny_real's
    tokenizer, BOS first) around the 576 patch rows."""
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(ROOT / "tests" / "fixtures" / "tiny_real")
    pre, _, post = LLAVA_PROMPT.partition("<image>")
    return len(tok.encode(pre)) + 576 + len(tok.encode(post, add_bos=False))


def llava_projections() -> list:
    """As :func:`zoo_projections`, llava_1_5_7b's fused tree (phase 26;
    Llama-2-7B's widths): qkv (4096 -> 12288, norm), wo (plain, residual),
    gate|up (4096 -> 2 x 11008 padded) and down (silu_mul, residual)."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    c = PRESETS["llava_1_5_7b"]
    p = make_plan(c)
    return [
        ("llava_1_5_7b_qkv", c.d_model, p.q_dim_p + 2 * p.kv_dim_p, "norm",
         False, False, True),
        ("llava_1_5_7b_wo", p.wo_in_p, c.d_model, "plain", False, True, True),
        ("llava_1_5_7b_gateup", c.d_model, 2 * p.ff_p, "norm", False, False,
         True),
        ("llava_1_5_7b_down", p.ff_p, c.d_model, "silu_mul", False, True,
         True),
    ]


def v2_lite_projections() -> list:
    """As :func:`zoo_projections`, deepseek_v2_lite's (phase 21): wo fused
    with its residual (#1, plain mode), the MLA projections, every
    expert's, the shared experts' and the dense lead layer's through #4 (a
    MoE model fuses no gate|up); wkv_a's 576 is packed 640 wide."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan
    from vlut_tpu_torch.models.transformer import _ffn_cfg

    c = PRESETS["deepseek_v2_lite"]
    p = make_plan(c)
    q_w = c.n_heads * (c.qk_nope_dim + c.qk_rope_dim)
    kv_w = -(-(c.kv_lora_rank + c.qk_rope_dim) // 128) * 128
    sh_p = make_plan(_ffn_cfg(c, c.n_shared_experts * c.d_ff)).ff_p
    dn_p = make_plan(_ffn_cfg(c, c.d_ff_dense)).ff_p
    return [
        ("deepseek_v2_lite_wo", p.wo_in_p, c.d_model, "plain", False, True,
         True),
        ("deepseek_v2_lite_wq_full", c.d_model, q_w, "plain", False, False,
         False),
        ("deepseek_v2_lite_wkv_a", c.d_model, kv_w, "plain", False, False,
         False),
        ("deepseek_v2_lite_expert_gate", c.d_model, p.ff_p, "plain", False,
         False, False),
        ("deepseek_v2_lite_expert_down", p.ff_p, c.d_model, "plain", False,
         False, False),
        ("deepseek_v2_lite_shared_gate", c.d_model, sh_p, "plain", False,
         False, False),
        ("deepseek_v2_lite_shared_down", sh_p, c.d_model, "plain", False,
         False, False),
        ("deepseek_v2_lite_dense_gate", c.d_model, dn_p, "plain", False,
         False, False),
        ("deepseek_v2_lite_dense_down", dn_p, c.d_model, "plain", False,
         False, False),
    ]


def recurrent_projections() -> list:
    """As :func:`zoo_projections`, the recurrent presets' (phase 22): the
    in_proj and out_proj of ``mamba_2_8b`` (2560 -> 10240, 5120 -> 2560)
    and of ``codestral_mamba_7b`` (4096 -> 18560: d_inner 8192, conv_dim
    10240, 128 heads; 8192 -> 4096), unfused: #4 at M <= 64, #3 above."""
    from vlut_tpu_torch.models.ssm import PRESETS, _proj_widths

    return [(f"{name}_{proj}", k, n, "plain", False, False, False)
            for name in ("mamba_2_8b", "codestral_mamba_7b")
            for proj, (k, n) in _proj_widths(PRESETS[name]).items()]


def zoo_decode_shapes() -> list:
    return [(label, k, n, mode, sub, res, m)
            for label, k, n, mode, sub, res, fused in zoo_projections()
            if fused for m in (1, 32, 64)]


def zoo_fused_quant_shapes() -> list:
    return [(label, k, n, m)
            for label, k, n, _, _, _, fused in zoo_projections()
            if not fused for m in (1, 32, 64)]


def zoo_prefill_lanes() -> list:
    return [(label, m, k, n) for label, k, n, *_ in zoo_projections()
            for m in (1024, 4096)]


def kv_kernels(dev, gen, record, shapes=None) -> None:
    """#5/#6 at ``bench/kv_study.py:SHAPES``, a layer's update as the
    composed path gives it (``kv_study.layer_update``): one call (and the
    same with int32 starts, and with a start out of range, which the kernel
    skips) must equal the plain assignment bit for bit, and the one-array
    form likewise; one call must run the writer's kernel alone (no cast or
    copy), in a profiler trace and in a CUDA graph of it.  Timed as the median of five CUDA graphs of 20 calls, beside
    one ``index_put_`` per array (the library call) and the plain version
    (``bench/kv_study.py`` times it in turns with other builds).
    ``shapes``: (label, B, S, Hkv, q8, hd) in place of the study's."""
    import statistics

    import torch

    from vlut_tpu_torch.bench import kv_study
    from vlut_tpu_torch.ops import kv_update

    def median_ms(fn):
        return statistics.median(cuda_ms(fn, graph=True) for _ in range(5))

    for label, b, s, hkv, q8, *hd in shapes or kv_study.SHAPES:
        hd = hd[0] if hd else 128
        caches, rows, start = kv_study.layer_update(gen, b, s, hkv, q8, hd=hd)
        scales = tuple(caches[2:] + rows[2:]) or None

        def call(st=start):
            kv_update.write_rows_pair(caches[0], caches[1], rows[0], rows[1],
                                      st, scales=scales)

        for st in (start, start.to(torch.int32)):
            want = [c.clone() for c in caches]
            for c, u in zip(want, rows):
                kv_update._write_plain(c, u, st)
            call(st)
            torch.cuda.synchronize()
            if not all(torch.equal(c, w) for c, w in zip(caches, want)):
                fail(f"KV row writer ({label}, {st.dtype}) differs from the "
                     "indexed assignment")
        skip = start.clone()
        skip[-1] = -1
        want = [c.clone() for c in caches]
        call(skip)
        one, w1 = caches[0].clone(), caches[0].clone()
        kv_update._write_plain(w1, rows[1], start)
        kv_update.write_rows(one, rows[1], start)
        torch.cuda.synchronize()
        if not (all(torch.equal(c, w) for c, w in zip(caches, want))
                and torch.equal(one, w1)):
            fail(f"KV row writer ({label}): a start out of range was "
                 "written, or the one-array form differs")
        del one, w1, want
        launched, captured = device_kernels(call), graph_kernels(call)
        for seen in (launched, captured):  # the trace, and a graph of it
            if len(seen) != 1 or "write_rows_kernel" not in seen[0]:
                fail(f"KV row writer ({label}): one call ran {seen}, not "
                     "the writer's kernel alone")
        ms = median_ms(call)
        plain_ms = cuda_ms(lambda: [kv_update._write_plain(c, u, start)
                                    for c, u in zip(caches, rows)])
        idx = (torch.arange(b, device=dev), start)
        lib_ms = statistics.median(
            library_ms(lambda: [c.index_put_(idx, u[:, 0])
                                for c, u in zip(caches, rows)])
            for _ in range(5))
        # each new row read once and written once, the starts read once
        nbytes = 2 * sum(u.numel() * u.element_size() for u in rows) + 8 * b
        b_ms, by = bound_ms(nbytes, 0)
        record("write_rows_pair" + ("" if label == "batched" else
                                    "_" + label),
               shape=f"{label} B={b} S={s} Hkv={hkv} hd={hd} arrays="
               f"{len(caches)} " + ("q8" if q8 else "bf16"),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=0.0, launched=launched,
               library=f"{len(caches)} index_put_ (one per array)")
        del caches, rows
        torch.cuda.empty_cache()


def attention_case(dev, gen, b: int, s: int, first: int) -> float:
    """#7 at the llama3_8b heads (8 KV heads of 32, hd 128), slot i at start
    first + i, against its plain version (rows equal, output to rtol and
    atol 2e-5)."""
    import torch

    from vlut_tpu_torch.ops import decode_attention as da

    hkv, h, hd = 8, 32, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    start = first + torch.arange(b, device=dev, dtype=torch.int32)
    q, kn, vn = randn(b, 1, h, hd), randn(b, 1, hkv, hd), randn(b, 1, hkv, hd)
    kc = randn(b, s, hkv, hd).to(torch.bfloat16)
    vc = randn(b, s, hkv, hd).to(torch.bfloat16)
    kw, vw = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, kn, vn, kw, vw, start, 0,
                                     scale=hd ** -0.5)
    got = da.decode_attention(q, kn, vn, kc, vc, start, 0, scale=hd ** -0.5)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
        fail(f"decode_attention B={b} S={s}: cache rows differ")
    err = (got - want).abs()
    if bool((err > ATT_ATOL + ATT_RTOL * want.abs()).any()):
        fail(f"decode_attention B={b} S={s}: beyond tolerance "
             f"(max {float(err.max())})")
    return float(err.max())


def tq_checks(dev, gen, checked) -> None:
    import torch

    from vlut_tpu_torch.bench.kernels import rand_packed
    from vlut_tpu_torch.ops import tq

    sms = tq.sm_count(dev.index or 0)
    forced = {(40, 4096, 1000, 2048), (130, 3584, 264, 512)}
    for fmt in ("tq2", "tq1"):
        for m, k, n, bk in tq.PLAN_SHAPES:
            packed = rand_packed(fmt, k, n, gen, dev)
            scales = (torch.rand((k // tq.QK, n), generator=gen, device=dev)
                      * 0.6 + 0.3).to(torch.float16)
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            xs = torch.rand((m, 1), generator=gen, device=dev) * 0.01
            want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt, bk=bk)
            plans = [None]
            if (m, k, n, bk) in forced:
                plans += [(bm, bn, sp) for bm, bn in tq.TILES
                          for sp in range(1, k // bk + 1)]
            for plan in plans:
                if plan is None:
                    got = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=bk)
                    plan = tq.tq_plan(m, -(-n // 16) * 16, k, bk, sms)
                    label = "plan"
                else:
                    got = tq._tq_cuda(xq, packed, scales, xs, fmt, bk,
                                      torch.float32, plan=plan)
                    label = "forced"
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    fail(f"tq_gemm {fmt} M={m} {k}->{n} bk={bk} {label} "
                         f"{plan}: differs from the plain version ({err})")
                checked("tq_gemm", f"M={m} {k}->{n} {fmt} bk={bk} {label}="
                        f"{plan}", err)
            del packed, want
            torch.cuda.empty_cache()


def tq_kernels(dev, gen, record) -> None:
    """#9 at the microbenchmark's llama3_8b shapes, tq2 and tq1, M 32 and
    256, with the bench's tile choice bk = 2048.  Kernel and plain version
    sum in the same float order: bit-exact.  The library yardstick is one
    float16 ``torch.matmul`` of the int8 codes with the weight dequantized
    to float16 beforehand (trits times the block scale; codes and scales
    are exact in float16)."""
    import torch

    from vlut_tpu_torch.bench.kernels import rand_packed
    from vlut_tpu_torch.ops import tq

    sms = tq.sm_count(dev.index or 0)
    for fmt in ("tq2", "tq1"):
        for label, k, n in (("dxd", 4096, 4096), ("dxff", 4096, 14336),
                            ("ffxd", 14336, 4096)):
            packed = rand_packed(fmt, k, n, gen, dev)
            scales = (torch.rand((k // tq.QK, n), generator=gen, device=dev)
                      * 0.06 + 0.01).to(torch.float16)
            wf = (tq.tq_trits(packed, fmt).to(torch.float16)
                  * scales.repeat_interleave(tq.QK, dim=0))
            rot = Rotation(packed)
            wrot = Rotation(wf)
            for m in (32, 256):
                xq = torch.randint(-127, 128, (m, k), generator=gen,
                                   device=dev, dtype=torch.int32).to(torch.int8)
                xs = torch.rand((m, 1), generator=gen, device=dev) * 0.01
                got = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=2048)
                want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt,
                                        bk=2048)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    fail(f"tq_gemm {fmt} {label} M={m}: differs from the "
                         f"plain version (max {err})")
                ms = cuda_ms(lambda: tq.tq_gemm(xq, rot.next(), scales, xs,
                                                fmt=fmt, bk=2048), graph=True)
                plain_ms = cuda_ms(lambda: tq.tq_gemm_plain(
                    xq, packed, scales, xs, fmt=fmt, bk=2048), iters=2,
                    warmup=1)
                xh = xq.to(torch.float16)
                lib_ms = library_ms(lambda: torch.matmul(xh, wrot.next()))
                b_ms, by = bound_ms(bench_bytes(fmt, m, k, n), 2 * m * k * n)
                record("tq_gemm", shape=f"{label} M={m} {k}->{n} {fmt}",
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                       library_ms=lib_ms, max_abs_err=err,
                       library="float16 torch.matmul of the codes and the "
                       "weight dequantized to float16 beforehand",
                       plan=tq.tq_plan(m, n, k, 2048, sms))
                del want, got
            del rot, wrot, wf
            torch.cuda.empty_cache()


ATT_RTOL = ATT_ATOL = 2e-5


# the device ms of #7 / #8 at the flagship engine's shape (B 32, S 2048)
# before head groups, when a block held all of a KV head's heads (NVIDIA
# H100 80GB HBM3, 700 W), printed beside this run's
BEFORE_GROUPS_MS = {False: 0.0535, True: 0.0426}
# the device ms of #7 / #8 at the same shape before the wide path (heads
# of at most 512 only; the same kernel instances), printed beside this
# run's (NVIDIA H100 80GB HBM3, 700 W)
BEFORE_WIDE_MS = {False: 0.0558, True: 0.0448}


def sdpa_backend(kernels: list[str]) -> str:
    """The backend of an SDPA call, read from the device kernels it ran."""
    for key, backend in (("cudnn", "cudnn"), ("fmha", "efficient"),
                         ("flash", "flash")):
        if any(key in k for k in kernels):
            return backend
    return f"math ({len(kernels)} kernels)"


def decode_attention_kernels(dev, gen, record, shapes=None) -> None:
    """#7 and #8 at the decode paths' shapes (bench/attention_study.py:
    SHAPES: the flagship engine's B 32, S 2048 with starts spread over
    64-1900, without and with a 512-row window, the flagship batched cache
    B 32 S 184, bench-sweep's tg at B 1 and 32 (S 552), tiny_real's heads,
    OuteTTS's cache (B 1, S 8192, 14 heads over 2) at its prefill's rows
    and full, falcon-7b's and starcoder's engines (B 16, S 2048, 71 and 48
    heads over 1), G 3 at hd 256, hdv != hd both ways, hd 512, and past
    512 the wide path's six shapes), with the tensors ``_layer_step``
    hands the kernel (bf16 q and rows, v a strided
    slice of the qkv output, int64 starts) and the cache rotated past the
    L2 where it fits in it.  Cache rows, codes and scales must equal the
    plain version's, the output (float32 summed in another order) agree to
    rtol and atol 2e-5, and two calls be bit-identical.  Each shape
    records its plan (cache rows per block, head groups), the host's eager
    dispatch of one call and the device kernels one call runs, which must
    be the kernel alone: no cast, copy or memset.  At the wide shapes and
    the engine's it also times the composed step's row write and
    attention (``Case.composed``), which the gate would take instead."""
    import torch

    from vlut_tpu_torch.bench import attention_study as st
    from vlut_tpu_torch.ops import decode_attention as da

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, b, s, hkv, g, hd, hdv, window, starts in shapes or st.SHAPES:
        for q8 in (False, True):
            name = ("decode_attention_int8" if q8 else "decode_attention") + (
                "" if label == "engine" else "_" + label)
            case = st.Case(gen, b, s, hkv, g, hd, window, starts, q8,
                           rotate=True, hdv=hdv)
            why, err = st.check_case(case)
            if why:
                fail(f"{name}: {why}")
            launched = device_kernels(case.call())
            # decode_attn_kernel, or past heads of 512 decode_attn_wide
            kernel = "decode_attn_wide" if da.wide(hd, hdv) else \
                "decode_attn_kernel"
            if len(launched) != 1 or kernel not in launched[0]:
                fail(f"{name}: one call ran {launched}, not the attention "
                     "kernel alone")
            ms = cuda_ms(case.call(), graph=True)
            plain_ms = cuda_ms(lambda: case.want(case.copies[0]), iters=3,
                               warmup=1)
            lib_ms = library_ms(case.sdpa())
            lib_ran = (sdpa_backend(device_kernels(case.sdpa(), capture=False))
                       if lib_ms is not None else "refused")
            # the composed step's row write and attention, which the gate
            # would take in the kernel's place: at the wide shapes and at
            # the flagship engine's for scale
            composed = ({"composed_ms": cuda_ms(case.composed(), graph=True)}
                        if da.wide(hd, hdv) or label == "engine" else {})
            rows = case.rows()
            h = hkv * g
            # visible rows read once (int8: codes and both scales), the new
            # rows, q, the output
            row_b = hkv * (hd + hdv + 8) if q8 else hkv * (hd + hdv) * 2
            nbytes = (rows * row_b + b * h * (hd * 2 + hdv * 4)
                      + b * hkv * (hd + hdv) * 2)
            b_ms, by = bound_ms(nbytes, 2.0 * rows * h * (hd + hdv),
                                F32_OPS_PER_S)
            extra = ({"before_groups_ms": BEFORE_GROUPS_MS[q8],
                      "before_wide_ms": BEFORE_WIDE_MS[q8]}
                     if label == "engine" else {})
            record(name, shape=(f"B={b} S={s} H={h} Hkv={hkv} hd={hd} "
                                f"hdv={hdv} window={window} rows={rows} "
                                + ("int8" if q8 else "bf16")),
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                   library_ms=lib_ms, max_abs_err=err, **extra, **composed,
                   rows_per_block=st.plan(case, sms),
                   heads_groups=da.head_groups(g, hd, hdv),
                   eager_us=st.eager_us(case.call()), launched=launched,
                   value_slices=da.value_slices(hd, hdv),
                   library="scaled_dot_product_attention(enable_gqa) over "
                   + ("the cache dequantized to bf16 beforehand" if q8
                      else "the bf16 rows"), library_ran=lib_ran)
            del case
            torch.cuda.empty_cache()


def main() -> None:
    t_start = time.time()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        import vlut_tpu_torch
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if pathlib.Path(vlut_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("vlut_tpu_torch was imported from outside this checkout")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    from vlut_tpu_torch.device import tf32
    from vlut_tpu_torch.ops import _build, kv_update, ternary_gemm as tg
    from vlut_tpu_torch.ops import decode_attention as da
    from vlut_tpu_torch.ops import tq

    # seconds from the start to each phase's start (the summary line's
    # phase_start_s)
    starts: dict[str, float] = {}

    def mark(phase: str) -> None:
        starts[phase] = time.time() - t_start

    # 1. build
    mark("build")
    t0 = time.time()
    logs = _build.build_all()
    build_s = time.time() - t0
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": list(logs)}), flush=True)

    # 2. kernels against their plain versions (the plain versions' float32
    # products in full float32: they are the references)
    mark("kernels")
    with tf32():
        kern = phase_kernels(dev)
    torch.cuda.empty_cache()
    # phases 3-28 run with TF32 allowed for matmuls and convolutions, as a
    # caller may allow it: every float32 entry of the port holds it off
    # itself (device.full_float32)
    allowed = contextlib.ExitStack()
    allowed.enter_context(tf32(matmul=True, conv=True))

    counters = {
        "ternary_gemm_decode": tg.ternary_gemm_decode,
        "ternary_gemm_fused_quant": tg.ternary_gemm_fused_quant,
        "ternary_gemm_tiled": tg.ternary_gemm_tiled,
        "write_rows_pair": kv_update.write_rows_pair,
        "decode_attention": da.decode_attention,
        "decode_attention_int8": da.decode_attention_int8,
        "tq_gemm": tq.tq_gemm,
    }
    launches: dict[str, dict[str, int]] = {}

    def reset():
        for f in counters.values():
            f.launches = 0

    def read(path: str, expect: tuple[str, ...]) -> dict[str, int]:
        """The counts of the path just driven; fails if a kernel the path
        runs was launched no time."""
        got = {name: f.launches for name, f in counters.items()}
        launches[path] = got
        for name in expect:
            if got[name] == 0:
                fail(f"{path} path never launched {name}")
        return got

    # 3. flagship at full width and depth, composed then fused attention
    mark("flagship")
    from vlut_tpu_torch.bench import flagship

    built = flagship.build_model("llama3_8b_158", dev)
    ab: dict[str, dict[str, float]] = {}
    for mode, attn_kernel in (("composed", "write_rows_pair"),
                              ("fused", "decode_attention")):
        toks = {}
        for graph in (True, False):
            run = "graph" if graph else "eager"
            reset()
            fl = flagship.run("llama3_8b_158", device=dev, decode_attn=mode,
                              built=built, cuda_graph=graph)
            got = read(f"flagship_{mode}_{run}", (
                "ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
            toks[run] = fl.pop("tokens").cpu()
            ab.setdefault("flagship_batched_S184", {})[f"{mode}_{run}"] = fl[
                "ms_per_step"]
            print(json.dumps({"phase": "flagship", **fl, "launches": got,
                              "card": card}), flush=True)
            torch.cuda.empty_cache()
        if not torch.equal(toks["graph"], toks["eager"]):
            fail(f"flagship batched ({mode}): the graphed step's greedy "
                 "tokens differ from the eager step's")

    # 4. real weights: tiny_real on the card and on the CPU
    mark("tiny_real")
    from vlut_tpu_torch.cli import run_batched
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    ids = [2] + list(b"The little model reads the lines of its own repo.")
    fixture = ROOT / "tests" / "fixtures" / "tiny_real"
    cfg, gpu_model, _ = load_checkpoint(fixture, device="cuda")
    _, cpu_model, _ = load_checkpoint(fixture, device="cpu")
    reset()
    toks_gpu = run_batched(gpu_model, cfg, ids, 4, 12, temp=0.0,
                           decode_attn="composed").cpu()
    launches_real = read("tiny_real_batched", (
        "ternary_gemm_decode", "ternary_gemm_fused_quant",
        "ternary_gemm_tiled", "write_rows_pair"))
    toks_eager = run_batched(gpu_model, cfg, ids, 4, 12, temp=0.0,
                             decode_attn="composed", cuda_graph=False).cpu()
    toks_cpu = run_batched(cpu_model, cfg, ids, 4, 12, temp=0.0,
                           decode_attn="composed")
    same = torch.equal(toks_gpu, toks_cpu) and torch.equal(toks_gpu,
                                                           toks_eager)
    # seeded sampling through generate: graphed equals eager on the card
    sampled = [run_batched(gpu_model, cfg, ids, 4, 12, temp=0.8, seed=5,
                           decode_attn="composed", cuda_graph=g).cpu()
               for g in (True, False)]
    print(json.dumps({"phase": "tiny_real", "prompt_tokens": len(ids),
                      "slots": 4, "n": 12, "tokens_gpu": toks_gpu[0].tolist(),
                      "tokens_cpu": toks_cpu[0].tolist(),
                      "tokens_gpu_eager": toks_eager[0].tolist(),
                      "identical": same,
                      "seeded_tokens": sampled[0][0].tolist(),
                      "seeded_graph_equals_eager": torch.equal(*sampled),
                      "launches": launches_real}), flush=True)
    if not same:
        fail("tiny_real greedy tokens differ between the card's graphed "
             "step, its eager step and the CPU")
    if not torch.equal(*sampled):
        fail("tiny_real seeded tokens differ between the graphed and the "
             "eager step")

    # 5. the slot engine at the flagship's full width
    mark("engine")
    from vlut_tpu_torch.bench import engine as bench_engine

    engine_out = {}
    for cache in ("bf16", "q8"):
        for mode in ("fused", "composed"):
            attn_kernel = {("bf16", "fused"): "decode_attention",
                           ("q8", "fused"): "decode_attention_int8"}.get(
                               (cache, mode), "write_rows_pair")
            for graph in (True, False):
                run = "graph" if graph else "eager"
                reset()
                # 40 requests of 64-1100 tokens (8 queued past the slots,
                # one chunked past 1024): fewer and shorter than the
                # bench's 48 of 64-1500, to keep the script near its time
                out = bench_engine.run(
                    device=dev, built=built, kv_quant=cache == "q8",
                    decode_attn=mode, cuda_graph=graph,
                    requests=bench_engine.make_requests(built[0].vocab_size,
                                                        n=40, hi=1100),
                    profile_steps=4 if mode == "fused" else 0,
                    check_paths=mode == "fused" and graph)
                got = read(f"engine_{cache}_{mode}_{run}", (
                    "ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
                engine_out[(cache, mode, run)] = out.pop("outputs")
                ab.setdefault(f"engine_{cache}_ctx2048", {})[
                    f"{mode}_{run}"] = out["decode_ms_per_step"]
                print(json.dumps({"phase": "engine", **out, "launches": got,
                                  "card": card}), flush=True)
                torch.cuda.empty_cache()
                if ("attention_paths" in out
                        and not bench_engine.paths_ok(out["attention_paths"])):
                    fail(f"flagship engine ({cache}): a fused layer differs "
                         f"from the composed one past "
                         f"{bench_engine.PATHS_X} x the noise floor: "
                         f"{out['attention_paths']}")
            if (engine_out[(cache, mode, "graph")]
                    != engine_out[(cache, mode, "eager")]):
                fail(f"flagship engine ({cache}, {mode}): the graphed step's "
                     "greedy tokens differ from the eager step's")
    agree = {}
    for cache in ("bf16", "q8"):
        pairs = [a == b for x, y in zip(engine_out[(cache, "fused", "graph")],
                                        engine_out[(cache, "composed",
                                                    "graph")])
                 for a, b in zip(x, y)]
        agree[cache] = sum(pairs) / len(pairs)
    print(json.dumps({"phase": "decode_attn_ab", "ms_per_step": ab,
                      "fused_vs_composed_token_agreement": agree,
                      "card": card}), flush=True)

    # 6. tiny_real through the engine on the card and on the CPU
    mark("tiny_real_engine")
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    texts = [b"The little model", b"reads the lines", b"of its own repo.",
             b"The", b"little model reads the lines of its own repo.", b"re"]

    def tiny_engine(model, cache, graph, samplers):
        eng = Engine(cfg, model, n_slots=4, max_len=256,
                     kv_quant=cache == "q8", cuda_graph=graph)
        reqs = [Request(prompt=[2] + list(t), max_new_tokens=12, sampler=sp)
                for t, sp in zip(texts, samplers)]
        eng.run(reqs)
        return [r.output for r in reqs], eng

    greedy = [SamplerParams(temperature=0.0)] * len(texts)
    for cache in ("bf16", "q8"):
        reset()
        outs, eng = tiny_engine(gpu_model, cache, True, greedy)
        got = read(f"tiny_real_engine_{cache}", (
            "decode_attention" if cache == "bf16"
            else "decode_attention_int8",))
        eager, _ = tiny_engine(gpu_model, cache, False, greedy)
        cpu, _ = tiny_engine(cpu_model, cache, True, greedy)
        same = outs == cpu and outs == eager
        print(json.dumps({"phase": "tiny_real_engine", "cache": cache,
                          "tokens_gpu": outs[0], "tokens_cpu": cpu[0],
                          "tokens_gpu_eager": eager[0], "identical": same,
                          "step_programs": eng.step_programs(),
                          "launches": got}), flush=True)
        if not same:
            fail(f"tiny_real engine ({cache}) tokens differ between the "
                 "card's graphed step, its eager step and the CPU")
    # seeded sampling (temperature 0.8, top-k 40, XTC, mirostat rows): the
    # noise drawn before each replay gives the eager step's tokens
    seeded = [SamplerParams(temperature=0.8, top_k=40, seed=i,
                            xtc_p=0.5 if i % 2 else 0.0, xtc_t=0.05,
                            mirostat_tau=5.0 if i % 3 == 2 else 0.0)
              for i in range(len(texts))]
    sampled = {g: tiny_engine(gpu_model, "bf16", g, seeded)[0]
               for g in (True, False)}
    print(json.dumps({"phase": "tiny_real_engine_seeded",
                      "tokens_graph": sampled[True][0],
                      "tokens_eager": sampled[False][0],
                      "identical": sampled[True] == sampled[False]}),
          flush=True)
    if sampled[True] != sampled[False]:
        fail("tiny_real engine seeded tokens differ between the graphed "
             "and the eager step")

    # 7. the completion server over the flagship engine
    mark("server")
    server_phase(built, fixture, card, reset, read)

    # 8-11. the microbenchmark, the end-to-end benches, perplexity and
    # requantization
    mark("tools")
    tools_phases(dev, built, fixture, card, reset, read,
                 (cfg, gpu_model, cpu_model, ids, toks_gpu))

    # 12-17. speculative decoding, lookahead, grammar, LoRA / control
    # vectors and slot save/restore
    mark("slice")
    slice_phases(dev, built, fixture, card, reset, read,
                 (cfg, gpu_model, cpu_model))

    # 18. the rest of the server: chat, tools, infill, embeddings, rerank,
    # the template, the web UI and routing; generate --promote
    mark("server_rest")
    server_rest_phase(dev, built, fixture, card, reset, read,
                      (cfg, gpu_model, cpu_model))

    # 19. the dense zoo: qwen3_4b and gemma2_2b at full width, and each
    # knob family on the card against the CPU
    mark("zoo")
    zoo_phase(dev, card, reset, read)

    # 20. heterogeneous stacks and MoE: Mixtral-8x7B's widths at full
    # width and depth, and the MoE / per-layer zoo families
    mark("moe")
    moe_phase(dev, card, reset, read)

    # 21. MLA, M-RoPE and the stacked cache: DeepSeek-V2-Lite's widths at
    # full width and depth, the MLA / M-RoPE zoo families, unroll=False
    mark("mla")
    mla_phase(dev, fixture, card, reset, read)

    # 22. the recurrent families: Mamba-2.8B's widths through the engine and
    # the server, Mamba2 at Codestral's through generate, and each family
    # card against CPU
    mark("recurrent")
    recurrent_phase(dev, fixture, card, reset, read)

    # 23. the encoder half: LLaDA-8B's widths denoised at full width and
    # depth, the encoder / T5 / gemma3n / diffusion families card against
    # CPU, cli embed and the embedding-only server, ModernBERT-base timed
    mark("encoder")
    encoder_phase(dev, fixture, card, reset, read)

    # 24. the HF converter: llama3_8b_158 in HF1BitLLM's layout converted
    # at full width on the card and served; families card against CPU; the
    # fixture's round trip through cli convert and generate
    mark("convert")
    convert_phase(dev, fixture, card, reset, read)

    # 25. the trainer: bitnet_2b_4t's float twin QAT-trained at full width
    # on the card, packed and served; the family converters card = CPU
    mark("train")
    train_phase(dev, card, reset, read)

    # 26. the vision half: llava_1_5_7b described at full width; every
    # vision family card against CPU
    mark("vision")
    vision_phase(dev, fixture, card, reset, read)

    # 27. the audio half: describe --audio (whisper-large-v3 + ultravox into
    # the flagship) and tts (outetts_0_2_500m + WavTokenizer) at full width;
    # the audio families and the CLI card against CPU
    mark("audio")
    audio_phase(dev, built, fixture, card, reset, read)

    # 28. the bench tooling: bench/ablate.py's matrix on phase 3's flagship,
    # composed and fused; the autotune table's lookups on this card
    mark("bench_tooling")
    bench_tooling_phase(dev, built, card, reset, read)
    allowed.close()

    # 29. the serving half of the mesh: the flagship at tp 2 and full width,
    # tiny_real at tp 2 and dp 2 (and one NCCL rank, graphed), Mixtral's
    # widths at ep 2, sp 2 and pp 2, in ranks sharing this card
    mark("mesh")
    mesh_phase(card, launches)

    # 30. the train half of the mesh: the flagship's widths (8 layers)
    # trained at tp 2 against one device, packed, served, a slot saved and
    # restored, in ranks sharing this card
    mark("train_mesh")
    train_mesh_phase(card, launches)

    # 31. summary
    mark("summary")
    replaces = {
        "ternary_gemm_decode": ("vlut_tpu_torch/csrc/decode_gemm.cu",
                                "vlut_tpu/ops/pallas_gemm.py:676"),
        "ternary_gemm_fused_quant": ("vlut_tpu_torch/csrc/decode_gemm.cu",
                                     "vlut_tpu/ops/pallas_gemm.py:336"),
        "ternary_gemm_tiled": ("vlut_tpu_torch/csrc/ternary_gemm.cu",
                               "vlut_tpu/ops/pallas_gemm.py:223"),
        "write_rows_pair": ("vlut_tpu_torch/csrc/kv_update.cu",
                            "vlut_tpu/ops/kv_update.py:76"),
        "decode_attention": ("vlut_tpu_torch/csrc/decode_attention.cu",
                             "vlut_tpu/ops/decode_attention.py:486"),
        "decode_attention_int8": ("vlut_tpu_torch/csrc/decode_attention.cu",
                                  "vlut_tpu/ops/decode_attention.py:378"),
        "tq_gemm": ("vlut_tpu_torch/csrc/tq_gemm.cu",
                    "vlut_tpu/ops/tq.py:182"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        k = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": sum(path.get(name, 0) for path in launches.values()),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    print(json.dumps({"launches": launches,
                      "timed_shapes": {n: k["shapes"] for n, k in kern.items()},
                      "checked_shapes": {n: k["checked"] for n, k in kern.items()
                                         if "checked" in k},
                      "phase_start_s": starts,
                      "seconds": time.time() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def mesh_phase(card, launches) -> None:
    """Phase 29: the serving half of the mesh in ranks started beside this
    process (``parallel/distributed.py:launch``; ``bench/mesh.py`` runs in
    each).  One card, so two ranks share it over gloo on CUDA tensors
    (NCCL refuses a second rank on a device); gloo's point-to-point ops go
    through the host (``parallel/_comm.py:GLOO_HOST_STAGED``).

    * ``llama3_8b_158`` at full width and depth (random weights, seed 0)
      through ``Engine(mesh=make_mesh(dp=1, tp=2, devices=[cuda:0,
      cuda:0]))`` (``bench/mesh.py:FLAGSHIP_TP2``): 32 slots, 128-token
      prompts, 10 greedy tokens each, against the same steps on one device
      over the same unfused tree and a bf16 cache
      (``bench/mesh.py:_step_reference``): the prefill logits within
      ``PREFILL_TOL`` (the K-sharded products are exact and llama has no
      sharded norm); the first decode step layer by layer, each layer from
      the mesh's input to it, within ``LAYER_TOL``, and its logits from
      the mesh's last layer within ``PREFILL_TOL`` (free-running, a random
      model turns one flipped int8 code into large logit moves: reported);
      the census of one decode step; ms per decode step past the first two
      beside a single-device graphed engine's;
    * tiny_real at tp 2 (bf16 fused, q8 fused, bf16 composed) and dp 2:
      greedy tokens equal to the CPU's at the same mesh shape (gloo CPU
      ranks), which equal the JAX mesh engine's (tests); the share equal
      to the single-device engine's printed;
    * one NCCL rank (a one-device mesh, graphed): its tokens equal the
      two-rank meshes';
    * ``mixtral_8x7b``'s widths, 4 of its 32 layers, at ep 2 (experts
      split, attention replicated and fused), held as the flagship;
    * sp 2 (ring attention, T 512) at the flagship's widths over 2 layers
      against the single-device forward, layer by layer: the ring's
      attention output within ``ATTN_TOL``, each layer within
      ``LAYER_TOL``, the logits from the last layer within
      ``PREFILL_TOL`` (free-running: reported); pp 2 (GPipe, 2
      microbatches) over 2 layers, its logits within ``PREFILL_TOL``.

    The limits are ``bench/mesh.py``'s, each of the largest value; a
    fault of the wiring reads far past them there
    (``python -m vlut_tpu_torch.bench.mesh``, PERF.md).

    Every rank's launches while its mesh path ran go into ``launches``;
    a kernel of a path that no rank launched fails the phase."""
    from vlut_tpu_torch.bench import mesh
    from vlut_tpu_torch.parallel.distributed import launch

    t0 = time.time()
    tiny = [("tp2", dict(dp=1, tp=2, single=True)), ("dp2", dict(dp=2, tp=1)),
            ("tp2_q8", dict(dp=1, tp=2, kv_quant=True)),
            ("tp2_composed", dict(dp=1, tp=2, decode_attn="composed"))]
    cases = ([("serve_rank", mesh.FLAGSHIP_TP2)]
             + [("tiny_real_rank", {**kw, "device": "cuda:0"})
                for _, kw in tiny]
             + [("serve_rank", dict(preset="mixtral_8x7b", n_layers=4, dp=1,
                                    tp=2, n_slots=16, ctx=256, prompt_len=128,
                                    new_tokens=8, device="cuda:0",
                                    single=False)),
                ("sp_rank", mesh.FLAGSHIP_SP2),
                ("pp_rank", dict(preset="llama3_8b_158", n_layers=2, b=4,
                                 t=128, device="cuda:0"))])
    target = "vlut_tpu_torch.bench.mesh:run_cases"
    try:
        ranks = launch(target, (cases,), nprocs=2, backend="gloo",
                       timeout=900)
        nccl = launch(target, ([("tiny_real_rank", dict(
            dp=1, tp=1, device="cuda:0"))],), nprocs=1, backend="nccl",
            timeout=300)[0][0]
        cpu = launch(target, ([("tiny_real_rank", {**kw, "device": "cpu"})
                               for _, kw in tiny[:3]],), nprocs=2,
                     backend="gloo", timeout=300)[0]
    except RuntimeError as e:
        fail(f"mesh: a rank failed\n{str(e)[-6000:]}")
    r0, r1 = ranks
    names = (["flagship_tp2"] + [f"tiny_real_{n}" for n, _ in tiny]
             + ["mixtral_ep2", "flagship_sp2", "flagship_pp2"])
    expect = {
        "flagship_tp2": ("ternary_gemm_fused_quant", "ternary_gemm_tiled",
                         "decode_attention"),
        "tiny_real_tp2": ("ternary_gemm_fused_quant", "ternary_gemm_tiled",
                          "decode_attention"),
        "tiny_real_dp2": ("ternary_gemm_decode", "decode_attention"),
        "tiny_real_tp2_q8": ("decode_attention_int8",),
        "tiny_real_tp2_composed": ("write_rows_pair",),
        "mixtral_ep2": ("ternary_gemm_decode", "ternary_gemm_fused_quant",
                        "ternary_gemm_tiled", "decode_attention"),
        "flagship_sp2": ("ternary_gemm_tiled",),
        "flagship_pp2": ("ternary_gemm_tiled",),
    }
    for i, name in enumerate(names):
        for rank, res in enumerate((r0[i], r1[i])):
            launches[f"mesh_{name}_rank{rank}"] = res["launches"]
        for k in expect[name]:
            if not all(res["launches"][k] for res in (r0[i], r1[i])):
                fail(f"mesh {name}: a rank never launched {k}")
    launches["mesh_tiny_real_nccl_rank0"] = nccl["launches"]

    def held(name, res, logits=(), rel=()):
        """Fail unless each logits reading is within PREFILL_TOL of the
        largest logit and each (key, limit) of ``rel`` within its limit."""
        for key in logits:
            e = res[key] if key else res
            if not e["max_abs_err"] <= mesh.PREFILL_TOL * e["max_abs_logit"]:
                fail(f"mesh {name} {key or 'logits'}: {e['max_abs_err']} "
                     f"past {mesh.PREFILL_TOL} of {e['max_abs_logit']}")
        for key, tol in rel:
            if not res[key] <= tol:
                fail(f"mesh {name} {key}: {res[key]} past {tol}")

    step_keys = ("prefill_logits", "step_layer_rel_err", "step_logits",
                 "free_step_logits")
    fl = r0[0]
    print(json.dumps({"phase": "mesh", "case": "flagship_tp2", **{
        k: fl[k] for k in ("mesh", "backend", "census", "wall_s",
                           "decode_steps", "timed_steps", "ms_per_step",
                           "single_ms_per_step", "single_tokens_equal",
                           "graphed") + step_keys},
        "launches_rank0": fl["launches"], "launches_rank1": r1[0]["launches"],
        "card": card}), flush=True)
    held("flagship tp2", fl, ("prefill_logits", "step_logits"),
         (("step_layer_rel_err", mesh.LAYER_TOL),))
    toks = {n: r0[1 + i]["tokens"] for i, (n, _) in enumerate(tiny)}
    same_cpu = {n: toks[n] == cpu[i]["tokens"]
                for i, (n, _) in enumerate(tiny[:3])}
    single = r0[1]["single_tokens"]
    print(json.dumps({
        "phase": "mesh", "case": "tiny_real", "tokens_tp2": toks["tp2"][1],
        "equal_to_cpu_mesh": same_cpu,
        "bf16_equal_across_meshes": all(
            toks[n] == toks["tp2"] for n in ("dp2", "tp2_composed")),
        "nccl_equal": nccl["tokens"] == toks["tp2"],
        "nccl_graphed": nccl["graphed"], "nccl_programs": nccl[
            "step_programs"],
        "share_equal_to_single_device": sum(
            a == b for a, b in zip(toks["tp2"], single)) / len(single)}),
        flush=True)
    if not all(same_cpu.values()):
        fail(f"mesh tiny_real: the card's mesh tokens differ from the CPU's "
             f"{same_cpu}")
    if toks["dp2"] != toks["tp2"] or toks["tp2_composed"] != toks["tp2"]:
        fail("mesh tiny_real: dp 2 or the composed attention gives other "
             "tokens than tp 2")
    if not (nccl["graphed"] and nccl["tokens"] == toks["tp2"]
            and any(p.get("replays") for p in nccl["step_programs"])):
        fail("mesh tiny_real: the one-rank NCCL mesh was not replayed from "
             "a graph or gives other tokens")
    mx = r0[5]
    print(json.dumps({"phase": "mesh", "case": "mixtral_ep2", "layers": 4,
                      **{k: mx[k] for k in ("census", "ms_per_step")
                         + step_keys}, "card": card}), flush=True)
    held("mixtral ep2", mx, ("prefill_logits", "step_logits"),
         (("step_layer_rel_err", mesh.LAYER_TOL),))
    for i, name in ((6, "sp2"), (7, "pp2")):
        print(json.dumps({"phase": "mesh", "case": f"flagship_{name}",
                          "layers": 2, **{f"rank{r}": {
                              k: v for k, v in res[i].items()
                              if k != "launches"}
                              for r, res in enumerate((r0, r1))},
                          "card": card}), flush=True)
    for res in (r0[6], r1[6]):
        held("sp2", res, ("held_logits",), (
            ("attn_rel_err", mesh.ATTN_TOL), ("layer_rel_err",
                                              mesh.LAYER_TOL)))
    for res in (r0[7], r1[7]):
        held("pp2", res, (None,))
    print(json.dumps({"phase": "mesh", "seconds": time.time() - t0}),
          flush=True)


def train_mesh_phase(card, launches) -> None:
    """Phase 30: the train half of the mesh, ``bench/mesh.py:train_rank``
    (``FLAGSHIP_TRAIN``) in two gloo ranks sharing this card, as phase 29
    runs its ranks.  Fails unless: (a) the tp-2 step's loss and every leaf
    kind (the embedding, the norms, the column and row shards, the head) lie
    within ``TRAIN_LOSS_RTOL`` / ``TRAIN_RTOL`` + ``TRAIN_ATOL`` of the
    single-device step, and each kind's SGD update within
    ``TRAIN_UPDATE_RTOL`` of the single-device update (in norm); (b) the QAT
    losses are finite and equal in both ranks, the packed tree's graphed
    tokens on one device equal its eager ones, and its tp-2 prefill and
    first decode step hold phase 29's limits; (c) the saved slot's K/V are
    rank 0's heads then rank 1's bit for bit, its restore into a fresh tp-2
    engine reads back bit-equal and continues with the uninterrupted run's
    tokens (every row reused), and a single-device engine reads it back
    bit-equal.  Each path's launches go into ``launches``: the single-device
    engine's #1, #3 and #7 graphed and eager, each rank's #4, #3 and #7 at
    tp 2."""
    import io

    import numpy as np

    from vlut_tpu_torch.bench import mesh
    from vlut_tpu_torch.parallel.distributed import launch

    t0 = time.time()
    try:
        r0, r1 = (r[0] for r in launch(
            "vlut_tpu_torch.bench.mesh:run_cases",
            ([("train_rank", mesh.FLAGSHIP_TRAIN)],), nprocs=2,
            backend="gloo", timeout=900))
    except RuntimeError as e:
        fail(f"train mesh: a rank failed\n{str(e)[-6000:]}")
    one = ("ternary_gemm_decode", "ternary_gemm_tiled", "decode_attention")
    tp2 = ("ternary_gemm_fused_quant", "ternary_gemm_tiled",
           "decode_attention")
    for path, got, expect in (
            ("train_mesh_single_graphed", r0["single_graphed_launches"], one),
            ("train_mesh_single_eager", r0["single_eager_launches"], one),
            ("train_mesh_tp2_rank0", r0["serve"]["launches"], tp2),
            ("train_mesh_tp2_rank1", r1["serve"]["launches"], tp2)):
        launches[path] = got
        for k in expect:
            if not got[k]:
                fail(f"train mesh {path}: never launched {k}")
    errs = r0["leaf_errors"]
    print(json.dumps({
        "phase": "train_mesh", "part": "gradient", "model": "llama3_8b_158",
        "layers": r0["layers"], "layers_cut_from": 32, "batch": r0["batch"],
        "mesh": r0["mesh"], "backend": r0["backend"],
        "master_params": r0["master_params"],
        "single_loss": r0["single_loss"], "tp_loss": r0["tp_loss"],
        "loss_rel_err": r0["loss_rel_err"], "leaf_errors": errs,
        "single_step_ms": r0["single_step_ms"],
        "tp_step_ms": [r0["tp_step_ms"], r1["tp_step_ms"]],
        "single_peak_gb": r0["single_peak_gb"], "card": card}), flush=True)
    kinds = {"embed", "final_norm", "attn_norm", "ffn_norm", "wq", "wk",
             "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
    if set(errs) != kinds:
        fail(f"train mesh: leaf kinds {sorted(errs)}, not {sorted(kinds)}")
    bad = {k: e for k, e in errs.items() if not (
        e["allclose_ratio"] <= 1
        and e["update_rel_err"] <= mesh.TRAIN_UPDATE_RTOL)}
    if bad or not r0["loss_rel_err"] <= mesh.TRAIN_LOSS_RTOL:
        fail(f"train mesh: the tp-2 step parts from one device's: loss "
             f"{r0['loss_rel_err']}, leaves {bad}")
    serve = r0["serve"]
    q = r0["qat_losses"]
    print(json.dumps({
        "phase": "train_mesh", "part": "qat_pack_serve", "qat_losses": q,
        "qat_step_ms": [r0["qat_step_ms"], r1["qat_step_ms"]],
        "qat_step_ms_median_after_first": [
            r0["qat_step_ms_median_after_first"],
            r1["qat_step_ms_median_after_first"]],
        "pack_ms": [r0["pack_ms"], r1["pack_ms"]],
        "peak_gb": [r0["train_peak_gb"], r1["train_peak_gb"]],
        "single_graphed_equals_eager": r0["single_graphed_equals_eager"],
        **{k: serve[k] for k in ("census", "ms_per_step", "prefill_logits",
                                 "step_layer_rel_err", "step_logits",
                                 "free_step_logits")},
        "card": card}), flush=True)
    if not (np.isfinite(q).all() and q == r1["qat_losses"]):
        fail(f"train mesh: the QAT losses are not finite or differ between "
             f"the ranks: {q} {r1['qat_losses']}")
    if not r0["single_graphed_equals_eager"]:
        fail("train mesh: the trained tree's graphed tokens differ from its "
             "eager ones")
    for key in ("prefill_logits", "step_logits"):
        e = serve[key]
        if not e["max_abs_err"] <= mesh.PREFILL_TOL * e["max_abs_logit"]:
            fail(f"train mesh tp2 {key}: {e['max_abs_err']} past "
                 f"{mesh.PREFILL_TOL} of {e['max_abs_logit']}")
    if not serve["step_layer_rel_err"] <= mesh.LAYER_TOL:
        fail(f"train mesh tp2: a layer of the step parts by "
             f"{serve['step_layer_rel_err']}")
    n = r0["saved_len"]
    with np.load(io.BytesIO(r0["saved"])) as z:
        same = len(z["tokens"]) == n and all(
            z[f"kv_{k}"].tobytes() == np.stack([np.concatenate(
                [r["slot_rows"][k][i][:n] for r in (r0, r1)], axis=1)
                for i in range(len(r0["slot_rows"][k]))]).tobytes()
            for k in ("k", "v"))
        shape = list(z["kv_k"].shape)
    print(json.dumps({
        "phase": "train_mesh", "part": "slots", "saved_rows": n,
        "kv_shape": shape, "bytes": len(r0["saved"]),
        "file_is_the_ranks_heads": same, "cont": r0["cont"],
        "restored_cont": r0["restored_cont"],
        "restored_reused": r0["restored_reused"],
        "restored_reads_back_equal": r0["restored_reads_back_equal"],
        "single_reads_back_equal": r0["single_reads_back_equal"],
        "seconds": time.time() - t0}), flush=True)
    if not same:
        fail("train mesh: the saved slot is not the ranks' heads bit for bit")
    if r0["restored_cont"] != r0["cont"] or r0["restored_reused"] != n:
        fail("train mesh: the restored slot continues otherwise than the "
             "uninterrupted run")
    if not (r0["restored_reads_back_equal"]
            and r0["single_reads_back_equal"]):
        fail("train mesh: the tp-2 engine or a single-device engine reads "
             "the restored file back otherwise")


def bench_tooling_phase(dev, built, card, reset, read) -> None:
    """Phase 28: ``bench/ablate.py``'s seven configurations on the flagship
    of phase 3 (``built``: full width and depth, 32 slots of 128-token
    prompts), the marginal ms a graphed step between n 8 and n 40, under
    the composed decode attention (#5 and PyTorch) and the fused one (#7;
    ``no_kv_write`` alone not applicable there); then the autotune table:
    on the card it was measured on, every entry answers its lookup."""
    import torch

    from vlut_tpu_torch.bench import ablate, autotune

    t_phase = time.time()
    out: dict = {"phase": "bench_tooling", "card": card}
    for attn, attn_kernel in (("composed", "write_rows_pair"),
                              ("fused", "decode_attention")):
        reset()
        res = ablate.run(built, dev, attn)
        out[f"launches_{attn}"] = read(f"ablate_{attn}", (
            "ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
        out[f"ms_per_step_{attn}"] = res
        bad = [k for k, v in res.items()
               if (v is None) == ablate.applicable(dict(ablate.CONFIGS)[k],
                                                   attn)
               or v is not None and not math.isfinite(v)]
        if bad:
            fail(f"ablate ({attn}): no time for {bad}: {res}")
        torch.cuda.empty_cache()

    table = autotune._read(str(autotune.TABLE_FILE))
    entries = table.get("entries", {})
    name = torch.cuda.get_device_name(dev)
    same_card = table.get("card", {}).get("name") == name
    wrong = []
    for key, v in entries.items() if same_card else ():
        if key.startswith("route:"):
            fmt, m, kp, np_ = key.split(":")[1:]
            got = autotune.lookup_route(fmt, int(m), int(kp), int(np_),
                                        dev.index or 0)
        else:
            fmt, m, kp, np_ = key.split(":")
            got = autotune.lookup(fmt, int(m), int(kp), int(np_),
                                  dev.index or 0)
            v = tuple(v)
        if got != v:
            wrong.append((key, v, got))
    out["table"] = {"table_card": table.get("card"), "this_card": name,
                    "live": same_card, "entries": len(entries),
                    "lookups_wrong": wrong}
    if wrong:
        fail(f"autotune table: lookups answer otherwise than the table on "
             f"its card: {wrong[:5]}")
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def bench_bytes(fmt: str, m: int, k: int, n: int) -> int:
    """Bytes a microbenchmark lane must move: x, the packed weights (and
    the TQ scales, or the i2/i1 channel scales), the row scales and the
    float32 output."""
    from vlut_tpu_torch.ops import tq
    from vlut_tpu_torch.ops.packing import TRITS_PER_BYTE, padded_k

    if fmt in tq.ROWS_PER_BLOCK:
        nb = -(-k // tq.QK)
        return (m * nb * tq.QK + nb * tq.ROWS_PER_BLOCK[fmt] * n
                + 2 * nb * n + 4 * m + 4 * m * n)
    np_ = -(-n // 128) * 128
    return (m * k + padded_k(k, fmt) // TRITS_PER_BYTE[fmt] * np_
            + 4 * np_ + 4 * m + 4 * m * np_)


def tools_phases(dev, built, fixture, card, reset, read, real) -> None:
    """Phases 8-11: the tools of the reference's evaluation loop on the
    card."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import e2e, kernels
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.convert.quantize import requantize
    from vlut_tpu_torch.eval.perplexity import logits_compare, perplexity
    from vlut_tpu_torch.models.transformer import forward

    # 8. the kernel microbenchmark: i2/i1 vs TQ2_0/TQ1_0
    reset()
    rows = kernels.main(["-m", "llama3_8b", "-ns", "32,256", "--fmt",
                         "i2,i1,tq2,tq1"])
    got = read("bench", ("ternary_gemm_tiled", "tq_gemm"))
    for r in rows:
        b_ms, by = bound_ms(bench_bytes(r["fmt"], r["m"], r["k"], r["n"]),
                            2 * r["m"] * r["k"] * r["n"])
        print(json.dumps({"phase": "bench", **r, "bound_us": b_ms * 1e3,
                          "bound_by": by, "card": card}), flush=True)
    print(json.dumps({"phase": "bench", "launches": got}), flush=True)
    torch.cuda.empty_cache()

    # 9. the end-to-end benches at full width and depth, i2 then i1
    i1 = e2e._load_model(None, "llama3_8b_158", "i1", dev)
    for fmt, model in (("i2", built), ("i1", i1)):
        reset()
        out = e2e.bench_sweep(preset="llama3_8b_158", fmt=fmt,
                              n_prompt=(512,), n_gen=(32,), batch=(1, 32),
                              repeats=2, device=dev, built=model)
        got = read(f"bench_sweep_{fmt}", ("ternary_gemm_tiled",
                                          "ternary_gemm_decode",
                                          "decode_attention"))
        for r in out:
            print(json.dumps({"phase": "bench_sweep", "fmt": fmt, **r,
                              "card": card}), flush=True)
        print(json.dumps({"phase": "bench_sweep", "fmt": fmt,
                          "launches": got}), flush=True)
        torch.cuda.empty_cache()
    del i1
    torch.cuda.empty_cache()
    reset()
    out = e2e.batched_bench(preset="llama3_8b_158", npp=(128,), ntg=(32,),
                            npl=(32,), device=dev, built=built)
    got = read("batched_bench", ("ternary_gemm_tiled", "ternary_gemm_decode",
                                 "decode_attention"))
    for r in out:
        print(json.dumps({"phase": "batched_bench", **r, "card": card}),
              flush=True)
    torch.cuda.empty_cache()

    # 10. perplexity of tiny_real, card vs CPU, and the lossless check
    cfg, gpu_model, cpu_model, prompt, toks_i2 = real
    text = np.frombuffer((ROOT / "SURVEY.md").read_bytes()[:1024],
                         np.uint8).astype(np.int32)
    reset()
    ppl_gpu = perplexity(gpu_model, cfg, text, window=128)
    cmp = logits_compare(gpu_model, cfg, text, "auto", "dequant", window=128)
    got = read("ppl", ("ternary_gemm_tiled",))
    ppl_cpu = perplexity(cpu_model, cfg, text, window=128)
    rel = abs(ppl_gpu["ppl"] - ppl_cpu["ppl"]) / ppl_cpu["ppl"]
    print(json.dumps({"phase": "ppl", "tokens": ppl_gpu["tokens"],
                      "window": 128, "ppl_gpu": ppl_gpu["ppl"],
                      "ppl_cpu": ppl_cpu["ppl"], "rel_diff": rel,
                      "quantized_vs_dequant": cmp, "launches": got,
                      "card": card}), flush=True)
    if rel > 1e-4:
        fail(f"tiny_real ppl differs between the card and the CPU ({rel})")
    if not (cmp["kl_mean"] < 0.05 and cmp["top1_agreement"] > 0.95):
        fail(f"quantized vs dequant out of bounds: {cmp}")

    # 11. requantize tiny_real to i1: the same greedy tokens on the card
    with tempfile.TemporaryDirectory() as tmp:
        dst = pathlib.Path(tmp) / "tiny_real_i1"
        requantize(fixture, dst, "i1")
        cfg1, model1, _ = load_checkpoint(dst, device="cuda")
        reset()
        toks_i1 = cli.run_batched(model1, cfg1, prompt, 4, 12, temp=0.0,
                                  decode_attn="composed").cpu()
        got = read("quantize_i1_batched", ("ternary_gemm_decode",
                                           "ternary_gemm_tiled"))
        ids_t = torch.tensor([prompt], device="cuda")
        pos = torch.arange(len(prompt), device="cuda")[None]
        with torch.inference_mode():
            diff = float((forward(gpu_model, cfg, ids_t, pos)[0]
                          - forward(model1, cfg1, ids_t, pos)[0]).abs().max())
        listing = io.StringIO()
        with contextlib.redirect_stdout(listing):
            cli.main(["inspect", str(fixture), "--hash"])
            cli.main(["inspect", str(dst), "--hash"])
        digests = [line for line in listing.getvalue().splitlines()
                   if line.startswith("model digest:")]
    same = torch.equal(toks_i1, toks_i2)
    print(json.dumps({"phase": "quantize", "fmt": cfg1.weight_fmt,
                      "tokens_i2": toks_i2[0].tolist(),
                      "tokens_i1": toks_i1[0].tolist(), "identical": same,
                      "max_abs_logit_diff": diff, "inspect": digests,
                      "launches": got}), flush=True)
    if not same or len(digests) != 2:
        fail("requantized i1 tiny_real gives other greedy tokens on the card "
             "(or inspect failed)")


def server_phase(built, fixture, card, reset, read) -> None:
    """8 concurrent greedy /completion requests (one streaming) to the port's
    server over the flagship model; every answer must be 200, carry the
    tokens of a direct Engine.run of the same prompts, and the server must
    count no error.  The engine loop starts once all 8 are queued, and the
    direct run takes them in the server's queue order, so both prefill the
    same groups (the random flagship amplifies float rounding, which
    differs between batch shapes, into other tokens)."""
    import concurrent.futures as cf
    import http.client

    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams
    from vlut_tpu_torch.serving.server import serve
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model = built
    tok = Tokenizer(fixture)
    texts = [f"Request {i}: " + "the little model reads its own repo. "
             * (1 + 3 * i) for i in range(8)]
    n_new = 16
    reset()
    engine = Engine(cfg, model, n_slots=8, max_len=2048)
    httpd, state = serve(engine, tok, port=0, start_engine=False)
    hostport = ("127.0.0.1", httpd.server_address[1])

    def post(i):
        conn = http.client.HTTPConnection(*hostport, timeout=600)
        body = {"prompt": texts[i], "n_predict": n_new, "temperature": 0.0,
                "ignore_eos": True, "return_tokens": True, "stream": i == 0}
        conn.request("POST", "/completion", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read().decode()
        conn.close()
        if r.status != 200:
            return r.status, None
        if i == 0:
            events = [json.loads(line[6:]) for line in raw.splitlines()
                      if line.startswith("data: ") and line != "data: [DONE]"]
            return r.status, events[-1].get("tokens")
        return r.status, json.loads(raw)["tokens"]

    try:
        t0 = time.time()
        with cf.ThreadPoolExecutor(8) as ex:
            pending = [ex.submit(post, i) for i in range(8)]
            while len(engine.queue) < 8 and time.time() - t0 < 120:
                time.sleep(0.01)
            order = [list(r.prompt) for r in engine.queue]
            state.start()
            answers = [f.result() for f in pending]
        wall = time.time() - t0
        conn = http.client.HTTPConnection(*hostport, timeout=60)
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        conn.close()
    finally:
        state.stop()
        httpd.shutdown()
        httpd.server_close()
        if state.thread.ident is not None:
            state.thread.join(timeout=60)
    got = read("server", ("ternary_gemm_decode", "decode_attention"))
    direct = [Request(prompt=p, max_new_tokens=n_new,
                      sampler=SamplerParams(temperature=0.0)) for p in order]
    Engine(cfg, model, n_slots=8, max_len=2048).run(direct)
    by_prompt = {tuple(r.prompt): r.output for r in direct}
    errors = [float(line.split()[-1]) for line in metrics.splitlines()
              if line.startswith("vlut_requests_errors_total")]
    same = [toks == by_prompt.get(tuple(tok.encode(t)))
            for (_, toks), t in zip(answers, texts)]
    print(json.dumps({"phase": "server", "requests": len(answers),
                      "status": [a[0] for a in answers],
                      "tokens_equal_direct": same, "wall_s": wall,
                      "requests_errors_total": errors, "launches": got,
                      "card": card}), flush=True)
    if any(a[0] != 200 for a in answers):
        fail(f"server answered {[a[0] for a in answers]}")
    if errors != [0.0]:
        fail(f"server counted errors: {errors}")
    if not all(same):
        fail("server tokens differ from a direct Engine.run")



def _http(hostport, method, path, body=None, timeout=600):
    """(status, content type, body bytes) of one request."""
    import http.client

    conn = http.client.HTTPConnection(*hostport, timeout=timeout)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), data


def _post(hostport, path, **body):
    status, _, data = _http(hostport, "POST", path, body)
    if status != 200:
        fail(f"POST {path} answered {status}: {data[:300]!r}")
    return json.loads(data)


def _sse_events(raw: bytes) -> list:
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def server_rest_phase(dev, built, fixture, card, reset, read, real) -> None:
    """Phase 18: the rest of the server.  (a) The flagship engine (32
    slots, ctx 2048, bf16 cache, fused attention, graphed; tiny_real's
    tokenizer for text): 8 concurrent greedy chats (one streamed, one with
    n 4) against a direct Engine.run of the templated ids in queue order,
    /apply-template, /infill against /completion of the prefix (on a
    one-slot flagship engine, the slot erased between them, while
    tiny_real's chats run on the card: two graphed models under one lock),
    /v1/embeddings of 32 inputs of 16-128 tokens in mean, last and cls
    bit-equal to a direct forward(output="hidden") pooled on the card,
    /v1/rerank of a 32-token query and 32 documents of 16-224 tokens
    against a direct call and a whole-logits forward, and one embeddings
    request sent while 8 streamed completions decode (their tokens those
    of a run without it).  (b) tiny_real on the card against the CPU:
    chat, a tool_choice "required" chat, embeddings, rerank and infill.
    (c) GET / (the web UI), routing by "model" over the flagship and
    tiny_real, a 404 for an unknown name, and ``generate --promote i1``
    against the requantized checkpoint.  The launch windows hold the
    server's requests alone: the references and timings run outside
    them."""
    import concurrent.futures as cf
    import contextlib
    import io
    import statistics
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.convert.quantize import requantize
    from vlut_tpu_torch.models.transformer import forward
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams
    from vlut_tpu_torch.serving import server as srv
    from vlut_tpu_torch.serving.chat import _parse_tool_calls
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model = built
    cfg_r, gpu_real, cpu_real = real
    tok = Tokenizer(fixture)
    greedy = SamplerParams(temperature=0.0)
    rng = np.random.default_rng(18)
    t_phase = time.time()
    out: dict = {"phase": "server_rest", "card": card}

    def big_engine():
        return Engine(cfg, model, n_slots=32, max_len=2048)

    def direct(prompts, n_new):
        """Greedy tokens of a fresh flagship engine over ``prompts``, taken
        in this order (the server's queue order)."""
        reqs = [Request(prompt=p, max_new_tokens=n_new, sampler=greedy)
                for p in prompts]
        big_engine().run(reqs)
        torch.cuda.empty_cache()
        return [r.output for r in reqs]

    def wait_queue(engine, n):
        t0 = time.time()
        while len(engine.queue) < n and time.time() - t0 < 120:
            time.sleep(0.005)
        if len(engine.queue) != n:
            fail(f"server_rest: {len(engine.queue)} of {n} requests queued")
        return [list(r.prompt) for r in engine.queue]

    # (a) the flagship behind the router, beside tiny_real on the card and
    # on the CPU; the engine loops start once the chats are queued
    flag = big_engine()
    engines = {
        "flagship": flag,
        "tiny_real": Engine(cfg_r, gpu_real, n_slots=4, max_len=512),
        "tiny_real_cpu": Engine(cfg_r, cpu_real, n_slots=4, max_len=512),
        # one flagship slot: /infill, the slot erased, then /completion,
        # each the first request of an empty slot (equal batch shapes)
        "one_slot": Engine(cfg, model, n_slots=1, max_len=512),
    }
    httpd, router = srv.serve_multi({n: (e, tok) for n, e in engines.items()},
                                    port=0, default="flagship",
                                    start_engine=False)
    hp = ("127.0.0.1", httpd.server_address[1])
    chats = [[{"role": "user", "content": f"Request {i}: "
               + "the little model reads its own repo. " * (1 + 3 * i)}]
             for i in range(8)]
    n_new = 16

    def chat(i):
        body = {"messages": chats[i], "max_tokens": n_new,
                "temperature": 0.0, "ignore_eos": True,
                "return_tokens": True, "stream": i == 0,
                "n": 4 if i == 1 else 1}
        status, _, raw = _http(hp, "POST", "/v1/chat/completions", body)
        if status != 200:
            return status, None
        if i == 0:
            ev = _sse_events(raw)
            text = "".join(e["choices"][0]["delta"].get("content", "")
                           for e in ev)
            return status, [(text, ev[-1]["choices"][0]["tokens"])]
        return status, [(c["message"]["content"], c["tokens"])
                        for c in json.loads(raw)["choices"]]

    # the inputs: 32 embeddings of 16-128 token ids (bucket 128: M 4096);
    # a rerank of a 32-token query and 32 documents of 16-224 tokens
    # (bucket 256: M 8192) as text, which tiny_real's tokenizer encodes one
    # id per character
    ids32 = [[int(t) for t in rng.integers(3, cfg.vocab_size, int(n))]
             for n in np.r_[128, 16, rng.integers(16, 129, 30)]]
    letters = list("abcdefghijklmnopqrstuvwxyz ")

    def text(n):
        return "".join(rng.choice(letters, int(n)))

    query = text(32 - len(tok.encode("")))
    docs_text = [text(n) for n in np.r_[224, 16, rng.integers(16, 225, 30)]]
    q_ids = tok.encode(query)
    d_ids = [tok.encode(d, add_bos=False) for d in docs_text]
    rerank_m = len(d_ids) * srv._bucket(len(q_ids) + max(map(len, d_ids)))
    real_bodies = {
        "chat": {"messages": chats[2], "max_tokens": 16},
        "tools": {"messages": [{"role": "user", "content": "weather?"}],
                  "max_tokens": 120, "tool_choice": "required",
                  "tools": [{"type": "function", "function": {
                      "name": "get_w", "parameters": {
                          "type": "object", "properties": {
                              "city": {"type": "string"}},
                          "required": ["city"]}}}]}}

    def real_chat(mname, name):
        return _post(hp, "/v1/chat/completions", model=mname,
                     temperature=0.0, return_tokens=True,
                     **real_bodies[name])["choices"][0]["tokens"]

    # the window holds the server's own requests alone; the references on
    # the card (direct forwards, direct calls, timings) come after it
    reset()
    try:
        t0 = time.time()
        with cf.ThreadPoolExecutor(8) as ex:
            pending = [ex.submit(chat, i) for i in range(8)]
            order = wait_queue(flag, 11)
            for st in router.states.values():
                st.start()
            answers = [f.result() for f in pending]
        out["chat_wall_s"] = time.time() - t0
        if any(a[0] != 200 for a in answers):
            fail(f"server_rest chats answered {[a[0] for a in answers]}")
        templ = [tok.apply_chat_template(c) for c in chats]
        prompt = _post(hp, "/apply-template", messages=chats[3])["prompt"]
        if prompt != tok.decode(templ[3]):
            fail("server_rest: /apply-template differs from the template")

        # /infill against /completion of the prefix, on one flagship slot;
        # tiny_real's chats on the card meanwhile: two graphed models on
        # one card capture and step under one lock
        prefix = "The little model reads the lines of its own"
        with cf.ThreadPoolExecutor(3) as ex:
            real_pending = {name: ex.submit(real_chat, "tiny_real", name)
                            for name in real_bodies}
            inf = _post(hp, "/infill", model="one_slot", input_prefix=prefix,
                        input_suffix=" repo.", n_predict=n_new,
                        temperature=0.0, ignore_eos=True, return_tokens=True)
            real_card = {k: f.result() for k, f in real_pending.items()}
        _post(hp, "/slots/0?action=erase", model="one_slot")
        comp = _post(hp, "/completion", model="one_slot", prompt=prefix,
                     n_predict=n_new, temperature=0.0, ignore_eos=True,
                     return_tokens=True)
        out["infill_equals_completion"] = inf["tokens"] == comp["tokens"]

        emb_route = {pooling: np.asarray([d["embedding"] for d in _post(
            hp, "/v1/embeddings", input=ids32, pooling=pooling)["data"]])
            for pooling in srv.POOLINGS}
        ranked = _post(hp, "/v1/rerank", query=query,
                       documents=docs_text)["results"]

        # (b) tiny_real on the card and the CPU
        real_cmp = {}
        for name in real_bodies:
            ta, tb = real_card[name], real_chat("tiny_real_cpu", name)
            real_cmp[name] = ta == tb
            if name == "tools":
                calls, _ = _parse_tool_calls(
                    "".join(tok.pieces()[t] for t in ta))
                real_cmp["tool_call"] = calls[:1]
        texts = ["The little model reads the lines of its own repo.",
                 "reads", "of its own repo, and some more words past 16", "T"]
        cos = []
        for pooling in srv.POOLINGS:
            a, b = (np.asarray([d["embedding"] for d in _post(
                hp, "/v1/embeddings", model=mname, input=texts,
                pooling=pooling)["data"]])
                for mname in ("tiny_real", "tiny_real_cpu"))
            cos.append(float((a * b).sum(-1).min()))
        real_cmp["embed_min_cosine"] = min(cos)
        docs_t = [" reads the lines", " zq xv", " of its own repo.", "!!"]
        a, b = (_post(hp, "/v1/rerank", model=mname, query="The little model",
                      documents=docs_t)["results"]
                for mname in ("tiny_real", "tiny_real_cpu"))
        real_cmp["rerank_same_order"] = ([r["index"] for r in a]
                                         == [r["index"] for r in b])
        real_cmp["rerank_max_rel_err"] = max(
            abs(x["relevance_score"] - y["relevance_score"])
            / abs(y["relevance_score"]) for x, y in zip(a, b))
        a, b = (_post(hp, "/infill", model=mname, input_prefix="The little",
                      input_suffix=" repo.", n_predict=12, temperature=0.0,
                      return_tokens=True)
                for mname in ("tiny_real", "tiny_real_cpu"))
        real_cmp["infill"] = a == b
        out["tiny_real_card_vs_cpu"] = real_cmp

        # (c) the web UI and routing
        status, ctype, data = _http(hp, "GET", "/")
        ui_ok = (status == 200 and ctype.startswith("text/html")
                 and data == srv.WEBUI.read_bytes())
        status, _, data = _http(hp, "GET", "/v1/models")
        listed = [m["id"] for m in json.loads(data)["data"]]
        unknown = _http(hp, "POST", "/completion",
                        {"prompt": "x", "model": "nope"})[0]
        out["web_ui"], out["models"], out["unknown_model_status"] = (
            ui_ok, listed, unknown)
        out["launches"] = read("server_rest", ("ternary_gemm_tiled",
                                               "ternary_gemm_decode",
                                               "decode_attention"))
    finally:
        for st in router.states.values():
            st.stop()
        httpd.shutdown()
        httpd.server_close()
        for st in router.states.values():
            if st.thread.ident is not None:
                st.thread.join(timeout=60)
    calls = real_cmp["tool_call"]
    if not calls or set(calls[0]["arguments"]) != {"city"}:
        fail(f"server_rest: tiny_real's tool call does not parse: {calls}")
    names = list(engines)
    errors = {n: st.metrics["requests_errors_total"]
              for n, st in router.states.items()}

    # the embeddings against a direct forward(output="hidden") pooled on
    # the card at the same shapes
    st = router.states["flagship"]
    toks, pos, lens = srv._padded(ids32, dev)
    with torch.inference_mode():
        hidden = forward(model, cfg, toks, pos, None, output="hidden")[0]
        h = hidden.float()
        valid = torch.arange(h.shape[1], device=dev)[None] < lens[:, None]
        pooled = {
            "mean": (h * valid[..., None]).sum(1)
            / torch.clamp(lens[:, None], min=1).float(),
            "last": h[torch.arange(h.shape[0], device=dev), lens - 1],
            "cls": h[:, 0]}
    emb = {}
    for pooling, want in pooled.items():
        want = want.cpu().numpy()
        want = want / np.maximum(
            np.linalg.norm(want, axis=-1, keepdims=True), 1e-12)
        got = emb_route[pooling]
        emb[pooling] = {
            "bit_equal": bool(np.array_equal(got, want.astype(np.float64))),
            "max_abs_err": float(np.abs(got - want).max()),
            "norm_err": float(np.abs(np.linalg.norm(got, axis=-1)
                                     - 1.0).max())}
    out["embeddings"] = emb
    del hidden, h, pooled

    # the rerank against a direct call, and the direct call against a
    # whole-logits forward
    scores = st.rerank(q_ids, d_ids)
    again = st.rerank(q_ids, d_ids)
    route_scores = {r["index"]: r["relevance_score"] for r in ranked}
    toks, pos, lens = srv._padded([q_ids + d for d in d_ids], dev)
    with torch.inference_mode():
        lg = forward(model, cfg, toks, pos, None)[0][..., :cfg.vocab_size]
        tgt = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], 1)
        lps = (lg.gather(-1, tgt[..., None])[..., 0]
               - torch.logsumexp(lg, dim=-1))
        del lg
        idx = torch.arange(toks.shape[1], device=dev)[None]
        m = (idx >= len(q_ids) - 1) & (idx < lens[:, None] - 1)
        whole = ((lps * m).sum(-1) / m.sum(-1)).tolist()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(scores, whole))
    out["rerank"] = {
        "M": rerank_m, "scores_min_max": [min(scores), max(scores)],
        "route_equals_direct": [route_scores.get(i) for i in range(
            len(scores))] == scores,
        "repeat_bit_equal": scores == again,
        "whole_logits_max_rel_err": rel,
        "route_ordered": [r["relevance_score"] for r in ranked] == sorted(
            scores, reverse=True)}

    # timings (host clock; embed and rerank end in a host copy)
    def med_ms(fn, n=3):
        fn()
        ts = []
        for _ in range(n):
            t1 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ts)

    ids_full = [x[:128] + [5] * (128 - len(x)) for x in ids32]
    out["embed_ms_32x128"] = med_ms(lambda: st.embed(ids_full, "mean"))
    out["rerank_ms_32_docs"] = med_ms(lambda: st.rerank(q_ids, d_ids))
    # #3's launches in one batch: its wrapper's count, and the device
    # kernels of one call in a profiler trace (which has dropped events in
    # a trace of some 4,000 kernels)
    from vlut_tpu_torch.ops import ternary_gemm as tg

    before = tg.ternary_gemm_tiled.launches
    st.embed(ids_full, "mean")
    out["tiled_launches_per_embed_batch"] = (
        tg.ternary_gemm_tiled.launches - before)
    launched = device_kernels(lambda: st.embed(ids_full, "mean"),
                              capture=False)
    out["tiled_device_kernels_per_embed_batch"] = sum(
        "tiled_gemm_kernel" in k for k in launched)
    out["device_kernels_per_embed_batch"] = len(launched)
    del engines, flag, router, st
    torch.cuda.empty_cache()

    # the chats against a direct run of the templated ids in queue order
    by_prompt = {tuple(p): o for p, o in zip(order, direct(order, n_new))}
    chat_ok = []
    for i, (_, choices) in enumerate(answers):
        want = by_prompt[tuple(templ[i])]
        chat_ok.append(len(choices) == (4 if i == 1 else 1) and all(
            toks_ == want and text == tok.decode(want)
            for text, toks_ in choices))
    out["chat_equal_direct"] = chat_ok

    # one embeddings request while 8 streamed completions decode
    reset()
    eng = big_engine()
    httpd, state = srv.serve(eng, tok, port=0, start_engine=False)
    hp = ("127.0.0.1", httpd.server_address[1])
    texts = [f"Request {i}: " + "the little model reads its own repo. "
             * (2 + 2 * i) for i in range(8)]
    n_long = 48

    def stream(i):
        status, _, raw = _http(hp, "POST", "/completion", {
            "prompt": texts[i], "n_predict": n_long, "temperature": 0.0,
            "ignore_eos": True, "return_tokens": True, "stream": True})
        return status, (_sse_events(raw)[-1].get("tokens")
                        if status == 200 else None)

    try:
        with cf.ThreadPoolExecutor(9) as ex:
            pending = [ex.submit(stream, i) for i in range(8)]
            order = wait_queue(eng, 8)
            state.start()
            t0 = time.time()
            while eng.perf.n_decode_steps < 2 and time.time() - t0 < 120:
                time.sleep(0.001)
            busy = sum(s.req is not None for s in eng.slots)
            steps_before = eng.perf.n_decode_steps
            emb_status = _http(hp, "POST", "/v1/embeddings",
                               {"input": ids32[:8], "pooling": "mean"})[0]
            steps_after = eng.perf.n_decode_steps
            streamed = [f.result() for f in pending]
        _, _, metrics = _http(hp, "GET", "/metrics")
        errors["concurrent"] = [
            float(line.split()[-1]) for line in metrics.decode().splitlines()
            if line.startswith("vlut_requests_errors_total")][0]
    finally:
        state.stop()
        httpd.shutdown()
        httpd.server_close()
        if state.thread.ident is not None:
            state.thread.join(timeout=60)
    got = read("server_rest_concurrent", ("ternary_gemm_tiled",
                                          "ternary_gemm_decode",
                                          "decode_attention"))
    del eng, state
    torch.cuda.empty_cache()
    by_prompt = {tuple(p): o for p, o in zip(order, direct(order, n_long))}
    out["concurrent"] = {
        "slots_busy_at_embed": busy, "decode_steps_before_embed": steps_before,
        "decode_steps_when_answered": steps_after, "status": [emb_status] + [
            s for s, _ in streamed],
        "tokens_equal_without": [toks_ == by_prompt[tuple(tok.encode(t))]
                                 for (_, toks_), t in zip(streamed, texts)],
        "launches": got}
    out["requests_errors_total"] = errors

    # (c) generate --promote i1 against the requantized checkpoint
    gen = ["generate", "-p", "The little model reads", "-n", "12", "--temp",
           "0", "--ctx", "128", "--device", dev.type]
    texts_out = []
    with tempfile.TemporaryDirectory() as tmp:
        dst = pathlib.Path(tmp) / "tiny_real_i1"
        requantize(fixture, dst, "i1")
        for argv in (["--model", str(fixture), "--promote", "i1"],
                     ["--model", str(dst)]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(gen + argv)
            texts_out.append(buf.getvalue())
    out["promote_i1_equals_requantized"] = texts_out[0] == texts_out[1]
    out["promote_text"] = texts_out[0].strip()
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)

    checks = {
        "flagship chats equal the direct engine": all(chat_ok),
        "/infill equals /completion of the prefix":
            out["infill_equals_completion"],
        "embeddings bit-equal to the direct forward": all(
            e["bit_equal"] and e["norm_err"] <= 1e-5 for e in emb.values()),
        "rerank equals a direct call": out["rerank"]["route_equals_direct"]
            and out["rerank"]["repeat_bit_equal"],
        "rerank within 1e-5 of the whole-logits forward": rel <= 1e-5,
        "rerank results ordered by score": out["rerank"]["route_ordered"],
        "rerank at M 8192": rerank_m == 8192,
        "#3 launched 128 times per embeddings batch":
            out["tiled_launches_per_embed_batch"] == 128,
        "tiny_real chat tokens card = CPU": real_cmp["chat"]
            and real_cmp["tools"],
        "tiny_real embeddings cosine >= 0.9999":
            real_cmp["embed_min_cosine"] >= 0.9999,
        "tiny_real rerank within rtol 1e-3, same order":
            real_cmp["rerank_same_order"]
            and real_cmp["rerank_max_rel_err"] <= 1e-3,
        "tiny_real infill card = CPU": real_cmp["infill"],
        "web UI served": ui_ok,
        "every model listed": listed == names,
        "unknown model answers 404": unknown == 404,
        "embedding overlapped the decode": busy == 8 and steps_before >= 2,
        "every answer 200": all(s == 200 for s in out["concurrent"][
            "status"]),
        "completions unchanged by the embedding": all(
            out["concurrent"]["tokens_equal_without"]),
        "no request error": not any(errors.values()),
        "generate --promote i1 = the requantized checkpoint":
            out["promote_i1_equals_requantized"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"server_rest: {bad}")


def zoo_phase(dev, card, reset, read) -> None:
    """Phase 19: the dense zoo.  (a) qwen3_4b and (b) gemma2_2b at full
    width and depth (random packed weights from the seed) through the
    engine, graphed against eager; (c) each knob family of the CPU tests
    (``bench/zoo.py``) on the card against the CPU; (d) the launches of
    each gated kernel per model (``read`` fails on a zero)."""
    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.runtime.engine import Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    t_phase = time.time()
    out: dict = {"phase": "zoo", "card": card}

    def engine_runs(name, built, runs, requests, n_slots, ctx, expect,
                    eager=None, paths=False):
        """Each (cache, mode) of ``runs`` graphed and (those of ``eager``,
        default all) eagerly, the tokens equal; with ``paths`` the first
        graphed run also compares the fused and composed paths' logits
        (bench/engine.py:compare_paths)."""
        toks, res = {}, {}
        for cache, mode in runs:
            for graph in (True, False):
                if not graph and eager is not None and (cache,
                                                        mode) not in eager:
                    continue
                run = "graph" if graph else "eager"
                reset()
                # the first cell's graphed run profiles 4 decode steps
                # (kernels by device time, idle share)
                prof = 4 if graph and (cache, mode) == runs[0] else 0
                r = bench_engine.run(
                    name, device=dev, built=built, kv_quant=cache == "q8",
                    decode_attn=mode, cuda_graph=graph, n_slots=n_slots,
                    ctx=ctx, requests=requests(), profile_steps=prof,
                    check_paths=paths and graph and (cache, mode) == runs[0])
                got = read(f"zoo_{name}_{cache}_{mode}_{run}",
                           expect(cache, mode))
                toks[(cache, mode, run)] = r.pop("outputs")
                res[f"{cache}_{mode}_{run}"] = {
                    k: r[k] for k in (
                        "decode_ms_per_step", "replay_ms_per_step",
                        "replayed_steps", "prompt_tok_per_s",
                        "decode_tok_per_s", "prompt_tokens", "decode_steps",
                        "capture_s", "wall_s")} | {
                    "launches": got, "profiled_steps": prof} | {
                    k: r[k] for k in ("profile", "attention_paths")
                    if k in r}
                print(json.dumps({"phase": "zoo", "model": name,
                                  "cache": cache, "decode_attn": mode,
                                  "run": run, **res[f"{cache}_{mode}_{run}"],
                                  "card": card}), flush=True)
                torch.cuda.empty_cache()
            if ((cache, mode, "eager") in toks and toks[(cache, mode, "graph")]
                    != toks[(cache, mode, "eager")]):
                fail(f"zoo {name} ({cache}, {mode}): the graphed step's "
                     "greedy tokens differ from the eager step's")
        return res

    # (a) qwen3_4b: 16 slots, ctx 2048, 16 greedy requests of 64-512 prompt
    # tokens (seed 12), 16 new tokens; bf16 fused (#7), q8 fused (#8), bf16
    # composed (#5)
    built = flagship.build_model("qwen3_4b", dev)
    cfg_q = built[0]
    attn_of = {("bf16", "fused"): "decode_attention",
               ("q8", "fused"): "decode_attention_int8"}
    out["qwen3_4b"] = engine_runs(
        "qwen3_4b", built, (("bf16", "fused"), ("q8", "fused"),
                            ("bf16", "composed")),
        lambda: bench_engine.make_requests(cfg_q.vocab_size, 16, 64, 512, 16,
                                           seed=12),
        16, 2048, lambda c, m: ("ternary_gemm_decode", "ternary_gemm_tiled",
                                attn_of.get((c, m), "write_rows_pair")))
    del built
    torch.cuda.empty_cache()

    # (a2) falcon-7b (bench/zoo.py:FALCON_7B, its published config.json:
    # d 4544, 32 layers, 71 heads of 64 over one KV head, parallel
    # attention and MLP, vocabulary 65024), random packed weights from seed
    # 19: 16 slots, ctx 2048, 16 greedy requests of 64-1000 prompt tokens
    # (seed 19), 16 new tokens; bf16 fused (#7, graphed and eager, with the
    # fused-vs-composed logits), q8 fused (#8) and bf16 composed (#5)
    # graphed; #7 / #8 launched once a layer every step
    built = zoo.hf_model(zoo.FALCON_7B, dev, seed=19)
    cfg_f = built[0]
    kinds = zoo.expected_kernels(cfg_f, built[1])
    falcon_kernels = {
        ("bf16", "fused"): kinds,
        ("q8", "fused"): tuple(k.replace("decode_attention",
                                         "decode_attention_int8")
                               for k in kinds),
        ("bf16", "composed"): zoo.expected_kernels(cfg_f, built[1],
                                                   "composed")}
    out["falcon_7b"] = engine_runs(
        "falcon_7b", built, (("bf16", "fused"), ("q8", "fused"),
                             ("bf16", "composed")),
        lambda: bench_engine.make_requests(cfg_f.vocab_size, 16, 64, 1000,
                                           16, seed=19),
        16, 2048, lambda c, m: falcon_kernels[(c, m)],
        eager={("bf16", "fused")}, paths=True)
    for run, attn in (("bf16_fused_graph", "decode_attention"),
                      ("bf16_fused_eager", "decode_attention"),
                      ("q8_fused_graph", "decode_attention_int8")):
        r = out["falcon_7b"][run]
        steps = r["decode_steps"] + r["profiled_steps"]
        if r["launches"][attn] != cfg_f.n_layers * steps:
            fail(f"falcon_7b {run}: {attn} launched "
                 f"{r['launches'][attn]} times in {steps} steps (want "
                 f"{cfg_f.n_layers} a step)")
    paths = out["falcon_7b"]["bf16_fused_graph"]["attention_paths"]
    if not bench_engine.paths_ok(paths):
        fail(f"falcon_7b: a fused layer differs from the composed one by "
             f"{paths['max_rel_layer_diff']} of its largest value, past "
             f"{bench_engine.PATHS_X} x the noise floor "
             f"{paths['noise_floor']}")
    del built
    torch.cuda.empty_cache()

    # (a3) heads wider than 512 through the engine
    out["wide_heads"] = wide_heads_case(dev, card, reset, read)

    # (b) gemma2_2b: 8 slots, ctx 8192, one greedy request of 5,000 tokens
    # (its 4,096 window bites on the even layers) and 8 of 64-512 tokens,
    # 16 new tokens (the long one 32, so that it still decodes past its
    # window when the ninth request is admitted), composed attention (the
    # softcap gate)
    built = flagship.build_model("gemma2_2b", dev, max_seq_len=8192)
    cfg_g, model_g = built

    def gemma_requests():
        rng = __import__("numpy").random.default_rng(12)
        long = Request(prompt=[int(t) for t in rng.integers(
            3, cfg_g.vocab_size, 5000)], max_new_tokens=32,
            sampler=SamplerParams(temperature=0.0))
        return [long] + bench_engine.make_requests(cfg_g.vocab_size, 8, 64,
                                                   512, 16, seed=12)

    out["gemma2_2b"] = engine_runs(
        "gemma2_2b", built, (("bf16", "composed"),), gemma_requests, 8, 8192,
        lambda c, m: ("ternary_gemm_decode", "ternary_gemm_fused_quant",
                      "ternary_gemm_tiled", "write_rows_pair"))
    # the tied bf16 head (256000 x 2304), cast to float32 per call as the
    # JAX package does (no kernel of its own), at the engine's decode M 8
    x = torch.randn((8, 1, cfg_g.d_model), device=dev).to(torch.bfloat16)
    head_ms = cuda_ms(lambda: tt.project_head(model_g, x), iters=5)
    n_head = model_g.embed.numel()
    # the function needs the bf16 head read once, x read and the float32
    # logits written; the cast adds a float32 copy written and read back
    need = 2 * n_head + 2 * x.numel() + 4 * 8 * cfg_g.vocab_size
    head_bound, head_by = bound_ms(need, 2.0 * n_head * 8, F32_OPS_PER_S)
    out["gemma2_2b_tied_head"] = {
        "ms": head_ms, "M": 8, "bound_ms": head_bound, "bound_by": head_by,
        "cast_traffic_ms": bound_ms(n_head * (2 + 4 + 4), 0)[0],
        "note": "bf16 embed.T cast to float32 then torch.matmul"}
    print(json.dumps({"phase": "zoo", "tied_head": out["gemma2_2b_tied_head"],
                      "card": card}), flush=True)
    del built, model_g
    torch.cuda.empty_cache()

    # (c) each knob family, card against CPU (each layer from the CPU's
    # input and the logits within 2e-2 of the largest, the CPU's greedy
    # tokens, graphed tokens equal to eager ones), its graphed decode the
    # family's counted path (d)
    fams = {}
    for name in zoo.FAMILIES:
        r = zoo.card_vs_cpu(name, dev, counters=(reset, read))
        fams[name] = r
        print(json.dumps({"phase": "zoo_family", **r, "card": card}),
              flush=True)
        if not r["within_tol"]:
            fail(f"zoo family {name}: a layer {r['max_rel_layer_err']} or "
                 f"the logits {r['max_rel_logit_err']} of the largest off "
                 f"the CPU's (tolerance {zoo.TOL})")
        if not r["greedy_equal"]:
            fail(f"zoo family {name}: the card's greedy tokens differ from "
                 "the CPU's")
        if not r["graph_equals_eager"]:
            fail(f"zoo family {name}: graphed tokens differ from eager ones")
    out["families"] = {n: {k: r[k] for k in (
        "max_rel_layer_err", "max_rel_logit_err", "greedy_equal",
        "free_rel_logit_err", "launches")} for n, r in fams.items()}
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def wide_heads_case(dev, card, reset, read) -> dict:
    """Phase 19 (a3): heads wider than 512 at model level.  ``tiny``'s
    fields with 4 heads of 576 over 2 (DeepSeek-V2's latent row width,
    padded to 640: #7 / #8's wide path, K in pieces of 512 + 128), 2
    layers, random packed weights from seed 25 (``bench/zoo.py:
    family_tree``), through the engine (4 slots, ctx 128, 6 greedy requests
    of 16-64 prompt tokens, seed 25, 12 new tokens) with the bf16 and the
    q8 cache, fused: on the card graphed (the counted path: #7 / #8 two a
    step) and eager, and on the CPU (the plain versions).  The tokens must
    be equal across the three, and each fused layer of a graphed run (from
    the composed step's input, ``bench/engine.py:compare_paths``) within
    ``PATHS_X`` of the layers' noise floor (``paths_ok``).  The composed
    step, graphed, is timed beside the fused one (#5 / #6 counted)."""
    import dataclasses

    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan
    from vlut_tpu_torch.ops import decode_attention as da

    t0 = time.time()
    cfg = dataclasses.replace(PRESETS["tiny"], head_dim=576)
    hd_p = make_plan(cfg).hd_p
    if hd_p != 640 or not da.wide(hd_p, hd_p):
        fail(f"wide heads: head_dim 576 padded to {hd_p}, not the wide path")
    tree = zoo.family_tree(cfg, seed=25)
    models = {"card": zoo.serving_model(cfg, tree, dev),
              "cpu": zoo.serving_model(cfg, tree, "cpu")}
    out: dict = {"hd_p": hd_p}
    for cache in ("bf16", "q8"):
        attn = "decode_attention_int8" if cache == "q8" else "decode_attention"
        toks, runs = {}, {}
        for run in ("graph", "eager", "cpu", "composed"):
            reset()
            r = bench_engine.run(
                "wide_heads", device="cpu" if run == "cpu" else dev,
                built=(cfg, models["cpu" if run == "cpu" else "card"]),
                kv_quant=cache == "q8",
                decode_attn="composed" if run == "composed" else "fused",
                cuda_graph=run in ("graph", "composed"), n_slots=4, ctx=128,
                requests=bench_engine.make_requests(cfg.vocab_size, 6, 16,
                                                    64, 12, seed=25),
                check_paths=run == "graph")
            toks[run] = r.pop("outputs")
            runs[run] = {k: r[k] for k in ("decode_steps",
                                           "decode_ms_per_step",
                                           "replay_ms_per_step")
                         if k in r}
            if run == "composed":
                # the step the gate would take without the wide path:
                # timed beside the fused one, not held to its tokens
                runs[run]["launches"] = read(
                    f"wide_heads_{cache}_composed_graph",
                    ("write_rows_pair",))
            elif run != "cpu":
                got = read(f"wide_heads_{cache}_fused_{run}", (attn,))
                runs[run]["launches"] = got
                if got[attn] != cfg.n_layers * r["decode_steps"]:
                    fail(f"wide heads {cache} {run}: {attn} launched "
                         f"{got[attn]} times in {r['decode_steps']} steps "
                         f"(want {cfg.n_layers} a step)")
            if run == "graph":
                paths = r.get("attention_paths")
                runs[run]["attention_paths"] = paths
                if paths is None or not bench_engine.paths_ok(paths):
                    fail(f"wide heads {cache}: a fused layer differs from "
                         f"the composed one by {paths['max_rel_layer_diff']}"
                         f" of its largest value, past {bench_engine.PATHS_X}"
                         f" x the noise floor {paths['noise_floor']}")
            torch.cuda.empty_cache()
        runs["graph_equals_eager"] = toks["graph"] == toks["eager"]
        runs["card_equals_cpu"] = toks["graph"] == toks["cpu"]
        runs["composed_equals_fused"] = toks["composed"] == toks["graph"]
        out[cache] = runs
        if not (runs["graph_equals_eager"] and runs["card_equals_cpu"]):
            fail(f"wide heads {cache}: tokens graphed / eager / CPU differ: "
                 f"{runs}")
    out["seconds"] = time.time() - t0
    print(json.dumps({"phase": "zoo", "wide_heads": out, "card": card}),
          flush=True)
    return out


def moe_phase(dev, card, reset, read) -> None:
    """Phase 20: heterogeneous stacks and mixture of experts.  (a)
    Mixtral-8x7B's published widths (``mixtral_8x7b``: d 4096, 32 layers,
    32/8 heads of 128, 8 experts of 14336, top 2, vocabulary 32000) at full
    width and depth, random packed weights from seed 0, through the engine
    (16 slots, ctx 2048, 16 greedy requests of 64-512 prompt tokens, seed
    13, 16 new tokens): bf16 fused (#7) graphed and eager (identical
    tokens, the graphed run profiling 4 steps), q8 fused (#8) graphed and
    bf16 composed (#5) graphed; (b) each MoE / heterogeneous family of the
    zoo (``bench/zoo.py`` MOE_FAMILIES) on the card against the CPU and
    graphed against eager.  ``read`` fails on a gated kernel launched no
    time."""
    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.bench import zoo

    t_phase = time.time()
    out: dict = {"phase": "moe", "card": card}
    name = "mixtral_8x7b"
    t0 = time.time()
    built = flagship.build_model(name, dev)
    cfg = built[0]
    out["build_s"] = time.time() - t0
    out["weight_bytes"] = sum(t.numel() * t.element_size()
                              for t in built[1].buffers())

    def requests():
        return bench_engine.make_requests(cfg.vocab_size, 16, 64, 512, 16,
                                          seed=13)

    runs = {}
    toks = {}
    for cache, mode, graph, attn_kernel in (
            ("bf16", "fused", True, "decode_attention"),
            ("bf16", "fused", False, "decode_attention"),
            ("q8", "fused", True, "decode_attention_int8"),
            ("bf16", "composed", True, "write_rows_pair")):
        run = "graph" if graph else "eager"
        reset()
        r = bench_engine.run(
            name, device=dev, built=built, kv_quant=cache == "q8",
            decode_attn=mode, cuda_graph=graph, n_slots=16, ctx=2048,
            requests=requests(),
            profile_steps=4 if (cache, mode, graph) == ("bf16", "fused", True)
            else 0)
        got = read(f"moe_{name}_{cache}_{mode}_{run}", (
            "ternary_gemm_decode", "ternary_gemm_fused_quant",
            "ternary_gemm_tiled", attn_kernel))
        toks[(cache, mode, run)] = r.pop("outputs")
        res = {k: r[k] for k in (
            "decode_ms_per_step", "replay_ms_per_step", "replayed_steps",
            "prompt_tok_per_s", "decode_tok_per_s", "prompt_tokens",
            "decode_steps", "capture_s", "wall_s")} | {"launches": got} | (
            {"profile": r["profile"]} if "profile" in r else {}) | (
            {"step_programs": r["step_programs"]} if "step_programs" in r
            else {})
        runs[f"{cache}_{mode}_{run}"] = res
        print(json.dumps({"phase": "moe", "model": name, "cache": cache,
                          "decode_attn": mode, "run": run, **res,
                          "card": card}), flush=True)
        torch.cuda.empty_cache()
    if toks[("bf16", "fused", "graph")] != toks[("bf16", "fused", "eager")]:
        fail(f"{name} (bf16, fused): the graphed step's greedy tokens differ "
             "from the eager step's")
    out[name] = runs
    del built
    torch.cuda.empty_cache()

    fams = {}
    for fam in zoo.MOE_FAMILIES:
        r = zoo.card_vs_cpu(fam, dev, counters=(reset, read))
        fams[fam] = r
        print(json.dumps({"phase": "moe_family", **r, "card": card}),
              flush=True)
        if not r["within_tol"]:
            fail(f"zoo family {fam}: a layer {r['max_rel_layer_err']} or "
                 f"the logits {r['max_rel_logit_err']} of the largest off "
                 f"the CPU's (tolerance {zoo.TOL})")
        if not r["greedy_equal"]:
            fail(f"zoo family {fam}: the card's greedy tokens differ from "
                 "the CPU's")
        if not r["graph_equals_eager"]:
            fail(f"zoo family {fam}: graphed tokens differ from eager ones")
    out["families"] = {n: {k: r[k] for k in (
        "max_rel_layer_err", "max_rel_logit_err", "greedy_equal",
        "free_rel_logit_err", "launches")} for n, r in fams.items()}
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def mla_phase(dev, fixture, card, reset, read) -> None:
    """Phase 21: MLA, M-RoPE and the stacked cache.  (a) DeepSeek-V2-Lite's
    published widths (``deepseek_v2_lite``) at full width and depth, random
    packed weights from seed 0, through the engine (16 slots, ctx 2048, 16
    greedy requests of 64-512 prompt tokens, seed 14, 16 new tokens): bf16
    graphed (4 steps profiled), bf16 eager for 4 new tokens (they must be
    the graphed run's first 4), q8 graphed, and one request of 500 prompt
    tokens decoding 24 past a 512-row context (the latent rows' context
    shift); (b) each MLA / M-RoPE family of the zoo (``bench/zoo.py``
    MLA_FAMILIES) on the card against the CPU and graphed against eager;
    (c) ``Engine(unroll=False)`` over a stacked cache on tiny_real and on
    the ``mla_plm`` family: the unrolled engine's tokens.  ``read`` fails
    on a gated kernel launched no time."""
    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    t_phase = time.time()
    out: dict = {"phase": "mla", "card": card}
    name = "deepseek_v2_lite"
    t0 = time.time()
    built = flagship.build_model(name, dev)
    cfg, model = built
    out["build_s"] = time.time() - t0
    out["weight_bytes"] = sum(t.numel() * t.element_size()
                              for t in model.buffers())
    expect = ("ternary_gemm_decode", "ternary_gemm_fused_quant",
              "ternary_gemm_tiled", "write_rows_pair")

    def requests(new_tokens):
        return bench_engine.make_requests(cfg.vocab_size, 16, 64, 512,
                                          new_tokens, seed=14)

    runs, toks = {}, {}
    for cache, graph, new in (("bf16", True, 16), ("bf16", False, 4),
                              ("q8", True, 16)):
        run = "graph" if graph else "eager"
        reset()
        r = bench_engine.run(
            name, device=dev, built=built, kv_quant=cache == "q8",
            cuda_graph=graph, n_slots=16, ctx=2048, requests=requests(new),
            profile_steps=4 if (cache, graph) == ("bf16", True) else 0)
        got = read(f"mla_{name}_{cache}_{run}", expect)
        toks[(cache, run)] = r.pop("outputs")
        res = {k: r[k] for k in (
            "decode_ms_per_step", "replay_ms_per_step", "replayed_steps",
            "prompt_tok_per_s", "decode_tok_per_s", "prompt_tokens",
            "decode_steps", "capture_s", "wall_s", "step_programs")} | {
                "launches": got} | (
            {"profile": r["profile"]} if "profile" in r else {})
        runs[f"{cache}_{run}"] = res
        print(json.dumps({"phase": "mla", "model": name, "cache": cache,
                          "run": run, **res, "card": card}), flush=True)
        torch.cuda.empty_cache()
    graphed = [t[:4] for t in toks[("bf16", "graph")]]
    if graphed != toks[("bf16", "eager")]:
        fail(f"{name} (bf16): the eager step's greedy tokens differ from the "
             "graphed step's first ones")
    # one request past a 512-row context: the latent rows' context shift
    reset()
    eng = Engine(cfg, model, n_slots=1, max_len=512)
    rng = __import__("numpy").random.default_rng(14)
    req = Request(prompt=[int(t) for t in rng.integers(3, cfg.vocab_size,
                                                        500)],
                  max_new_tokens=24, sampler=SamplerParams(temperature=0.0))
    t0 = time.time()
    eng.run([req])
    got = read(f"mla_{name}_context_shift", expect)
    shift = {"shifted_tokens": eng.perf.n_shifted_tokens,
             "tokens": req.output, "seconds": time.time() - t0,
             "launches": got}
    print(json.dumps({"phase": "mla", "model": name, "context_shift": shift,
                      "card": card}), flush=True)
    if (eng.perf.n_shifted_tokens == 0 or len(req.output) != 24
            or not all(0 <= t < cfg.vocab_size for t in req.output)):
        fail(f"{name}: the request past the context did not shift and "
             "finish")
    out[name] = runs | {"context_shift": shift}
    del built, model, eng
    torch.cuda.empty_cache()

    fams = {}
    for fam in zoo.MLA_FAMILIES:
        r = zoo.card_vs_cpu(fam, dev, counters=(reset, read))
        fams[fam] = r
        print(json.dumps({"phase": "mla_family", **r, "card": card}),
              flush=True)
        if not r["within_tol"]:
            fail(f"zoo family {fam}: a layer {r['max_rel_layer_err']} or "
                 f"the logits {r['max_rel_logit_err']} of the largest off "
                 f"the CPU's (tolerance {zoo.TOL})")
        if not r["greedy_equal"]:
            fail(f"zoo family {fam}: the card's greedy tokens differ from "
                 "the CPU's")
        if not r["graph_equals_eager"]:
            fail(f"zoo family {fam}: graphed tokens differ from eager ones")
    out["families"] = {n: {k: r[k] for k in (
        "max_rel_layer_err", "max_rel_logit_err", "greedy_equal",
        "free_rel_logit_err", "launches")} for n, r in fams.items()}

    # (c) the stacked tree over a stacked cache against the unrolled engine
    stacked = {}
    cfg_r, model_r, _ = load_checkpoint(fixture, device="cuda")
    cfg_p = zoo.family_config("mla_plm")
    model_p = tt.TransformerLM(cfg_p, tt._tree_to(zoo.family_tree(cfg_p),
                                                  dev))
    for label, c, m in (("tiny_real", cfg_r, model_r),
                        ("mla_plm", cfg_p, model_p)):
        outs = []
        for unroll in (True, False):
            reset()
            eng = Engine(c, m, n_slots=4, max_len=256, unroll=unroll)
            reqs = [Request(prompt=[2] + list(b), max_new_tokens=12,
                            sampler=SamplerParams(temperature=0.0))
                    for b in (b"The little model", b"reads the lines",
                              b"of its own repo.", b"re")]
            eng.run(reqs)
            read(f"mla_stacked_{label}_{'unrolled' if unroll else 'stacked'}",
                 ("ternary_gemm_decode",))
            outs.append([r.output for r in reqs])
            if not unroll and eng.cache["k"].dim() != 5:
                fail(f"{label}: unroll=False did not serve a stacked cache")
        stacked[label] = {"tokens": outs[1][0],
                          "identical": outs[0] == outs[1]}
        if outs[0] != outs[1]:
            fail(f"{label}: the stacked engine's tokens differ from the "
                 "unrolled engine's")
    out["stacked"] = stacked
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def recurrent_phase(dev, fixture, card, reset, read) -> None:
    """Phase 22: the recurrent families.  (a) Mamba-2.8B's published widths
    (``mamba_2_8b``) at full width and depth, random packed weights from
    seed 0, through the engine (16 slots, ctx 2048, 16 greedy requests of
    64-1000 prompt tokens, seed 15, 16 new tokens), graphed (4 steps
    profiled) and eager: identical tokens; the launches of #4 / #3 in one
    decode step over 16 slots and in one 1000-token prefill; (b) one
    greedy completion through the server: the tokens of a direct engine
    run; (c) Mamba2 at Mamba-Codestral-7B's widths (``codestral_mamba_7b``)
    through ``generate``'s loop, 128 prompt tokens then 16 greedy tokens,
    and 8 seeded ones twice (identical); (d) each family of
    ``bench/recurrent_zoo.py`` on the card against the CPU, layer by layer;
    a tiny Mamba engine graphed, eager and on the CPU: identical tokens;
    (a2) a 2,500-token prompt past the largest bucket, in chunks that
    continue its slot's state, graphed and eager: identical tokens.
    ``read`` fails on a gated kernel launched no time."""
    import http.client

    import numpy as np
    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.bench import recurrent_zoo as rz
    from vlut_tpu_torch.cli import family_generate
    from vlut_tpu_torch.models import ssm
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams
    from vlut_tpu_torch.serving.server import serve
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    t_phase = time.time()
    out: dict = {"phase": "recurrent", "card": card}
    expect = ("ternary_gemm_fused_quant", "ternary_gemm_tiled")
    name = "mamba_2_8b"
    t0 = time.time()
    built = flagship.build_model(name, dev)
    cfg, model = built
    torch.cuda.synchronize()
    out["build_s"] = time.time() - t0
    out["weight_bytes"] = {
        "packed": sum(t.numel() for n_, t in model.named_buffers()
                      if n_.endswith("_packed")),
        "all": sum(t.numel() * t.element_size() for t in model.buffers())}
    rng = np.random.default_rng(15)
    greedy = SamplerParams(temperature=0.0)

    # the kernels of one decode step over 16 slots and of one 1000-token
    # prefill (counted here, then reset for the main path)
    counts = {}
    with torch.inference_mode():
        st = ssm.init_state(cfg, 16, dev)
        reset()
        ssm.forward(model, cfg, torch.zeros((16, 1), dtype=torch.long,
                                            device=dev), st, inplace=True)
        counts["decode_step_16_slots"] = read(f"recurrent_{name}_one_step",
                                              ("ternary_gemm_fused_quant",))
        reset()
        ssm.forward(model, cfg, torch.from_numpy(
            rng.integers(3, cfg.vocab_size, (1, 1000))).to(dev),
            ssm.init_state(cfg, 1, dev), logits_last_only=True)
        counts["prefill_1000"] = read(f"recurrent_{name}_one_prefill",
                                      ("ternary_gemm_tiled",))
    out["launches_per_call"] = {k: {n_: v for n_, v in c.items() if v}
                                for k, c in counts.items()}
    del st
    torch.cuda.empty_cache()

    def requests():
        return bench_engine.make_requests(cfg.vocab_size, 16, 64, 1000, 16,
                                          seed=15)

    runs, toks = {}, {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        reset()
        r = bench_engine.run(name, device=dev, built=built, cuda_graph=graph,
                             n_slots=16, ctx=2048, requests=requests(),
                             profile_steps=4 if graph else 0)
        got = read(f"recurrent_{name}_{run}", expect)
        toks[run] = r.pop("outputs")
        res = {k: r[k] for k in (
            "decode_ms_per_step", "replay_ms_per_step", "replayed_steps",
            "prompt_tok_per_s", "decode_tok_per_s", "prompt_tokens",
            "prompt_s", "decode_steps", "capture_s", "wall_s",
            "step_programs")} | {"launches": got} | (
            {"profile": r["profile"]} if "profile" in r else {})
        runs[run] = res
        print(json.dumps({"phase": "recurrent", "model": name, "run": run,
                          **res, "card": card}), flush=True)
        torch.cuda.empty_cache()
    if toks["graph"] != toks["eager"]:
        fail(f"{name}: the graphed step's greedy tokens differ from the "
             "eager step's")
    out[name] = runs

    # (b) one completion through the server against a direct engine run
    ids = [int(t) for t in rng.integers(3, cfg.vocab_size, 300)]
    reset()
    engine = Engine(cfg, model, n_slots=16, max_len=2048)
    httpd, state = serve(engine, Tokenizer(fixture), port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=600)
        conn.request("POST", "/completion", body=json.dumps({
            "prompt": ids, "n_predict": 16, "temperature": 0.0,
            "ignore_eos": True, "return_tokens": True}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        answer = json.loads(resp.read().decode())
        conn.close()
    finally:
        state.stop()
        httpd.shutdown()
        httpd.server_close()
    got = read(f"recurrent_{name}_server", expect)
    direct = Request(prompt=ids, max_new_tokens=16, sampler=greedy)
    Engine(cfg, model, n_slots=16, max_len=2048).run([direct])
    server = {"status": resp.status, "tokens": answer.get("tokens"),
              "direct_tokens": direct.output, "launches": got}
    print(json.dumps({"phase": "recurrent_server", **server}), flush=True)
    if resp.status != 200 or answer.get("tokens") != direct.output:
        fail(f"{name}: the server's completion differs from a direct engine "
             "run")
    out["server"] = server

    # (a2) a prompt past the largest prefill bucket: 2,500 tokens (two full
    # 1,024-token chunks through #3, each continuing its slot's state, then
    # a 452-token remainder left-padded into the 512 bucket) beside a
    # 300-token prompt, graphed and eager: identical tokens
    long_ids = [int(t) for t in rng.integers(3, cfg.vocab_size, 2500)]
    short_ids = [int(t) for t in rng.integers(3, cfg.vocab_size, 300)]
    long_runs, long_toks = {}, {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        eng = Engine(cfg, model, n_slots=16, max_len=4096, cuda_graph=graph)
        forwards = []

        def spy(tb, rows, _real=eng._prefill_recurrent, _seen=forwards):
            _seen.append({"bucket": tb, "offsets": [r[1] for r in rows],
                          "tokens": [len(r[2]) for r in rows]})
            return _real(tb, rows)

        eng._prefill_recurrent = spy
        reqs = [Request(prompt=ids_, max_new_tokens=16, sampler=greedy)
                for ids_ in (long_ids, short_ids)]
        reset()
        t0 = time.time()
        eng.run(reqs)
        torch.cuda.synchronize()
        got = read(f"recurrent_{name}_long_prompt_{run}", expect)
        long_toks[run] = [r.output for r in reqs]
        big = eng.prefill_buckets[-1]
        long_runs[run] = {
            "wall_s": time.time() - t0, "prompt_s": eng.perf.t_prompt_s,
            "prompt_tokens": eng.perf.n_prompt_tokens,
            "chunk_forwards": sum(f["bucket"] == big and all(
                t == big for t in f["tokens"]) for f in forwards),
            "prefill_forwards": forwards, "launches": got}
        print(json.dumps({"phase": "recurrent_long_prompt", "model": name,
                          "run": run, **long_runs[run],
                          "tokens": long_toks[run][0], "card": card}),
              flush=True)
        if (eng.perf.n_prompt_tokens != 2800
                or long_runs[run]["chunk_forwards"] != 2
                or any(len(r.output) != 16 or r.error for r in reqs)):
            fail(f"{name}: the 2,500-token prompt ran {forwards}, "
                 f"{eng.perf.n_prompt_tokens} prompt tokens")
        del eng
        torch.cuda.empty_cache()
    if long_toks["graph"] != long_toks["eager"]:
        fail(f"{name}: a prompt past the largest bucket gives other tokens "
             "graphed than eager")
    out["long_prompt"] = long_runs
    del built, model, engine
    torch.cuda.empty_cache()

    # (c) Mamba2 at Codestral's widths through generate's loop
    name2 = "codestral_mamba_7b"
    t0 = time.time()
    cfg2, model2 = flagship.build_model(name2, dev)
    build2 = time.time() - t0
    ids2 = [int(t) for t in rng.integers(3, cfg2.vocab_size, 128)]
    reset()
    t0 = time.time()
    toks2 = family_generate(model2, cfg2, ids2, 16)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    got = read(f"recurrent_{name2}_generate", expect)
    sampled = [family_generate(model2, cfg2, ids2, 8, temp=0.8, seed=7)
               for _ in range(2)]
    gen2 = {"layers": cfg2.n_layers, "build_s": build2,
            "prompt_tokens": len(ids2), "tokens": toks2, "seconds": gen_s,
            "sampled": sampled[0], "launches": got}
    print(json.dumps({"phase": "recurrent_mamba2", **gen2}), flush=True)
    if (len(toks2) != 16 or not all(0 <= t < cfg2.vocab_size for t in toks2)
            or sampled[0] != sampled[1]):
        fail(f"{name2}: generate did not give 16 tokens in the vocabulary, "
             "or its seeded draws did not repeat")
    out[name2] = gen2
    del model2
    torch.cuda.empty_cache()

    # (d) each family card against CPU; a tiny Mamba engine graphed / eager /
    # on the CPU
    fams = {}
    for fam in rz.FAMILIES:
        r = rz.card_vs_cpu(fam, dev, counters=(reset, read), prompt=40)
        fams[fam] = r
        print(json.dumps({"phase": "recurrent_family", **r, "card": card}),
              flush=True)
        if not r["within_tol"]:
            fail(f"recurrent family {fam}: a layer {r['max_rel_layer_err']} "
                 f"(tolerance {rz.TOL}) or the logits "
                 f"{r['max_rel_logit_err']} (tolerance {rz.LOGIT_TOL}) of "
                 "the largest off the CPU's")
        if not r["greedy_equal"]:
            fail(f"recurrent family {fam}: the card's greedy tokens differ "
                 "from the CPU's")
    out["families"] = {n_: {k: r[k] for k in (
        "max_rel_layer_err", "max_rel_logit_err", "greedy_equal",
        "free_rel_logit_err", "launches")} for n_, r in fams.items()}
    cfg_m, tree = rz.family("mamba")
    prompts = [[int(t) for t in rng.integers(1, cfg_m.vocab_size, n_)]
               for n_ in (5, 40, 17, 90, 1, 33)]
    engines = {}
    for label, device, graph in (("graph", dev, True), ("eager", dev, False),
                                 ("cpu", "cpu", True)):
        eng = Engine(cfg_m, rz.model_on(cfg_m, tree, device), n_slots=4,
                     max_len=256, cuda_graph=graph)
        reqs = [Request(prompt=p_, max_new_tokens=12, sampler=greedy)
                for p_ in prompts]
        if label == "graph":
            reset()
        eng.run(reqs)
        if label == "graph":
            read("recurrent_tiny_mamba_engine", expect)
        engines[label] = [r_.output for r_ in reqs]
    out["tiny_mamba_engine"] = {"tokens": engines["graph"][0],
                                "identical": engines["graph"] == engines[
                                    "eager"] == engines["cpu"]}
    if not out["tiny_mamba_engine"]["identical"]:
        fail("tiny Mamba engine: graphed, eager and CPU tokens differ")
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def generate_entry_points(dev, fixture) -> dict:
    """``cli generate``'s diffusion and T5 branches through ``cli.main`` on
    the card and on the CPU: tiny_real made a diffusion checkpoint (the
    float twin denoised, each card layer from the CPU's input), and
    ``bench/encoder_zoo.py``'s gated T5 at tiny_real's vocabulary and
    tokenizer (a free run).  The printed text must be the CPU's."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import encoder_zoo as ez
    from vlut_tpu_torch.bench.zoo import layers_replaced
    from vlut_tpu_torch.convert.checkpoint import save_checkpoint

    def text_of(argv, device, seen=None, by=None):
        buf = io.StringIO()
        ctx = (layers_replaced(seen, by=by) if seen is not None
               else contextlib.nullcontext())
        with ctx, contextlib.redirect_stdout(buf):
            cli.main(argv + ["--device", str(device)])
        # the text before the summary line
        return buf.getvalue().rsplit("\n[", 1)[0]

    prompt = ["-p", "The little model", "--temp", "0"]
    entry = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        diff = pathlib.Path(d) / "diffusion"
        shutil.copytree(fixture, diff)
        meta = json.loads((diff / "vlut_config.json").read_text())
        meta["model_config"].update(causal_attn=False, mask_token_id=255,
                                    diffusion_shift_logits=False)
        (diff / "vlut_config.json").write_text(json.dumps(meta))
        argv = ["generate", "--model", str(diff), "-n", "16",
                "--diffusion-steps", "8", *prompt]
        want_l, got_l = [], []
        want = text_of(argv, "cpu", want_l)
        got = text_of(argv, dev, got_l, by=want_l)
        entry["diffusion"] = {"text": want, "equal": got == want,
                              "layers_compared": len(got_l)}
        t5_dir = pathlib.Path(d) / "t5"
        vocab = 256  # tiny_real's tokenizer
        cfg = dataclasses.replace(ez.config_of("t5_gated"), vocab_size=vocab)
        tensors = dict(ez.STRUCTURES["t5_gated"]["tensors"],
                       embed=[vocab, cfg.d_model])
        save_checkpoint(t5_dir, cfg, ez.random_tree(tensors, 5),
                        tokenizer_src=fixture)
        argv = ["generate", "--model", str(t5_dir), "-n", "8", *prompt]
        want = text_of(argv, "cpu")
        got = text_of(argv, dev)
        entry["t5"] = {"text": want, "equal": got == want}
    return entry


def encoder_phase(dev, fixture, card, reset, read) -> None:
    """Phase 23: the encoder half of the non-transformer families.  (a)
    LLaDA-8B's published widths (``llada_8b``) at full width and depth,
    random packed weights from seed 0 (the fused tree, int8 head), denoised
    by ``diffusion_generate`` over the packed tree: 128 prompt tokens (seed
    16), 128 new, 128 steps, blocks of 32, low_confidence, greedy, twice
    (identical tokens, no mask token left); each step one bidirectional
    forward at M 256 through #3; the launches and a profile of one forward;
    (b) each family of ``bench/encoder_zoo.py`` on the card against the CPU
    (the encoders, T5 gated and ungated, gemma3n; llada, dream and
    llada_moe packed and as float twins through the denoise loop, each
    layer from the CPU's input); (c) ``cli embed`` through ``cli.main`` and
    an embedding-only server on a small ModernBERT checkpoint (tiny_real's
    tokenizer): the CPU's embeddings, 400 "embedding-only" on
    /completion; ``cli generate`` on a diffusion and a T5 checkpoint
    (:func:`generate_entry_points`; the diffusion branch denoises the
    float twin, where (a) times the packed tree); (d) ModernBERT-base's widths (random float32 weights):
    ms per ``embed`` batch of 32 x 512, the median of 3.  ``read`` fails
    on a gated kernel launched no time."""
    import contextlib
    import http.client
    import io
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import encoder_zoo as ez
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.convert.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from vlut_tpu_torch.models import encoder
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.runtime.diffusion import (DiffusionParams,
                                                  diffusion_generate)
    from vlut_tpu_torch.serving.server import serve_multi
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    t_phase = time.time()
    out: dict = {"phase": "encoder", "card": card}

    # (a) llada_8b, denoised at full width and depth
    name = "llada_8b"
    t0 = time.time()
    cfg, model = flagship.build_model(name, dev)
    torch.cuda.synchronize()
    out["build_s"] = time.time() - t0
    out["weight_bytes"] = {
        "packed": sum(t.numel() for n_, t in model.named_buffers()
                      if n_.endswith("packed")),
        "all": sum(t.numel() * t.element_size() for t in model.buffers())}
    rng = np.random.default_rng(16)
    ids = [int(t) for t in rng.integers(3, cfg.mask_token_id, 128)]
    n_new = 128
    dp = DiffusionParams(steps=128, block_len=32, alg="low_confidence")
    total = len(ids) + n_new
    toks = torch.tensor([ids + [cfg.mask_token_id] * n_new], device=dev)
    pos = torch.arange(total, device=dev)[None]
    full = torch.ones((1, total, total), dtype=torch.bool, device=dev)

    def one_forward():
        with torch.inference_mode():
            return tt.forward(model, cfg, toks, pos, None, attn_mask=full)[0]

    one_forward()
    reset()
    one_forward()
    torch.cuda.synchronize()
    per_fwd = read(f"{name}_one_forward", ("ternary_gemm_tiled",))
    out["launches_per_forward"] = {k: v for k, v in per_fwd.items() if v}
    out["profile_one_forward"] = flagship.profile_decode(one_forward, 1)
    gens = []
    n_fwd = [0]

    def counted_forward(*a, **kw):
        n_fwd[0] += 1
        return tt.forward(*a, **kw)

    for run in range(2):
        reset()
        n_fwd[0] = 0
        t0 = time.time()
        got_toks = diffusion_generate(model, cfg, ids, n_new, dp,
                                      forward_fn=counted_forward)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = read(f"{name}_generate_{run}", ("ternary_gemm_tiled",))
        forwards = n_fwd[0]
        gens.append({"run": run, "seconds": secs, "forwards": forwards,
                     "ms_per_step": secs * 1e3 / forwards,
                     "new_tok_per_s": n_new / secs, "tokens": got_toks,
                     "launches": {k: v for k, v in got.items() if v}})
        print(json.dumps({"phase": "encoder_llada", "model": name,
                          **gens[-1], "card": card}), flush=True)
    if gens[0]["tokens"] != gens[1]["tokens"]:
        fail(f"{name}: two greedy denoise runs gave different tokens")
    if (cfg.mask_token_id in gens[0]["tokens"]
            or len(gens[0]["tokens"]) != n_new):
        fail(f"{name}: the denoised response kept a mask token")
    out[name] = {k: v for k, v in gens[0].items() if k != "tokens"}
    out[name]["second_run_s"] = gens[1]["seconds"]
    del model
    torch.cuda.empty_cache()

    # (b) each family card against CPU
    fams = {}
    for fam in ez.FAMILIES:
        r = ez.card_vs_cpu(fam, dev, counters=(reset, read))
        fams[fam] = r
        print(json.dumps({"phase": "encoder_family", **r, "card": card}),
              flush=True)
        if not (r["within_tol"] and r["equal"]):
            fail(f"encoder family {fam}: off the CPU's outputs or tokens "
                 f"({ {k: v for k, v in r.items() if k != 'tokens'} })")
    out["families"] = {n_: {k: v for k, v in r.items()
                            if k not in ("family", "tokens")}
                       for n_, r in fams.items()}

    # (c) cli embed and the embedding-only server on a small ModernBERT
    small = encoder.EncoderConfig(
        arch="modernbert", vocab_size=256, d_model=64, n_layers=3,
        n_heads=4, d_ff=96, local_window=8, ln_eps=1e-5, pooling="mean")
    texts = ["The little model", "reads the lines of its own repo."]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        save_checkpoint(d, small,
                        ez.random_tree(ez.modernbert_layout(small), 3),
                        tokenizer_src=fixture)
        cfg_c, cpu_model, _ = load_checkpoint(d, device="cpu")
        tok = Tokenizer(d)
        want = []
        for text in texts:
            t = torch.tensor([tok.encode(text)[:cfg_c.max_seq_len]])
            want.append(encoder.embed(cpu_model, cfg_c, t,
                                      torch.ones_like(t))[0])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["embed", "--model", d, "--json", "-p", texts[0], "-p",
                      texts[1], "--device", str(dev)])
        got = json.loads(buf.getvalue())["embeddings"]
        cli_err = max(float((torch.tensor(g) - w).abs().max())
                      for g, w in zip(got, want))
        _, card_model, _ = load_checkpoint(d, device=dev)
        httpd, router = serve_multi(
            {"emb": ((cfg_c, card_model), tok)}, port=0)
        try:
            port = httpd.server_address[1]

            def post(path, body):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=300)
                conn.request("POST", path, body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read().decode()
                conn.close()
                return resp.status, data

            st_e, data = post("/v1/embeddings", {"input": texts})
            vecs = [d_["embedding"] for d_ in json.loads(data)["data"]]
            want_s = [w / w.norm().clamp(min=1e-12) for w in want]
            srv_err = max(float((torch.tensor(v) - w).abs().max())
                          for v, w in zip(vecs, want_s))
            st_c, data_c = post("/completion", {"prompt": "x"})
        finally:
            httpd.shutdown()
            httpd.server_close()
    entry = {"cli_embed_abs_err": cli_err, "server_status": st_e,
             "server_abs_err": srv_err, "completion_status": st_c,
             "completion_answer": data_c[:80],
             "generate": generate_entry_points(dev, fixture)}
    print(json.dumps({"phase": "encoder_entry_points", **entry}),
          flush=True)
    if cli_err > ez.EMBED_TOL or srv_err > ez.EMBED_TOL or st_e != 200:
        fail(f"encoder entry points off the CPU's embeddings: {entry}")
    if st_c != 400 or "embedding-only" not in data_c:
        fail(f"the embedding-only server answered /completion: {entry}")
    if not all(g["equal"] for g in entry["generate"].values()):
        fail(f"cli generate's diffusion or T5 branch off the CPU's text: "
             f"{entry['generate']}")
    out["entry_points"] = entry

    # (d) ModernBERT-base's widths: ms per embed batch of 32 x 512
    mb = ez.MODERNBERT_BASE
    t0 = time.time()
    mbm = ez.model_on(mb, ez.random_tree(ez.modernbert_layout(mb), 0), dev)
    torch.cuda.synchronize()
    build_mb = time.time() - t0
    gen = torch.Generator(device=dev).manual_seed(23)
    toks_mb = torch.randint(1, mb.vocab_size, (32, 512), generator=gen,
                            device=dev)
    mask_mb = torch.ones_like(toks_mb)
    e = encoder.embed(mbm, mb, toks_mb, mask_mb)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(e).all()) or e.shape != (32, mb.d_model):
        fail("ModernBERT-base: embeddings not finite or not (32, 768)")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        encoder.embed(mbm, mb, toks_mb, mask_mb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["modernbert_base"] = {
        "batch": [32, 512], "build_s": build_mb,
        "ms_per_batch": sorted(times)[1], "ms_runs": times,
        "tok_per_s": 32 * 512 / (sorted(times)[1] / 1e3),
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in mbm.buffers())}
    del mbm
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def slice_phases(dev, built, fixture, card, reset, read, real) -> None:
    """Phases 12-17: speculative decoding, lookahead, grammar-constrained
    sampling, LoRA / control vectors and slot save/restore, at the
    flagship's full width (random weights) and on tiny_real (card against
    CPU)."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.convert.checkpoint import write_safetensors
    from vlut_tpu_torch.models.transformer import (
        TransformerLM, init_params_fast, quantize_head)
    from vlut_tpu_torch.runtime import grammar as gm
    from vlut_tpu_torch.runtime import lora
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    cfg_t, model_t = built
    greedy = SamplerParams(temperature=0.0)
    scratch = ROOT / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)

    def requests(n=32, lo=128, hi=512, new=32, seed=2):
        return bench_engine.make_requests(cfg_t.vocab_size, n, lo, hi, new,
                                          seed)

    def drive(path, expect, graph=True, n_slots=32, reqs=None, model=None,
              cfg=None, **kw):
        """One engine over ``reqs``, its launches read as ``path``."""
        reset()
        eng = Engine(cfg or cfg_t, model or model_t, n_slots=n_slots,
                     max_len=2048, cuda_graph=graph, **kw)
        reqs = reqs if reqs is not None else requests()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read(path, expect)
        bad = [r.rid for r in reqs if r.error or not r.done]
        if bad:
            fail(f"{path}: requests {bad} did not finish")
        return [r.output for r in reqs], eng, got, wall

    def stats(eng, wall):
        p = eng.perf
        steps = max(p.n_decode_steps, 1)
        return {"wall_s": wall, "rounds": p.n_spec_rounds,
                "decode_steps": p.n_decode_steps,
                "ms_per_round": 1e3 * p.t_decode_s / steps,
                "tokens_per_round": p.n_decode_tokens / steps,
                "drafted": p.n_spec_drafted, "accepted": p.n_spec_accepted,
                "acceptance": (p.n_spec_accepted / p.n_spec_drafted
                               if p.n_spec_drafted else None),
                "prompt_tok_s": (p.n_prompt_tokens / p.t_prompt_s
                                 if p.t_prompt_s else None),
                "capture_s": p.t_capture_s,
                "step_programs": eng.step_programs()}

    def share_equal(a, b):
        pairs = [x == y for u, v in zip(a, b) for x, y in zip(u, v)]
        return sum(pairs) / max(len(pairs), 1)

    def done():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # 12. speculative decoding at full width: the flagship with a random
    # bitnet_2b_4t draft (same 128,256 vocabulary), k 4, 32 slots
    t_phase = time.time()
    plain, eng, _, wall = drive("spec_plain", ("ternary_gemm_decode",))
    plain_stats = stats(eng, wall)
    del eng
    done()
    d_cfg, d_model = flagship.build_model("bitnet_2b_4t", dev, seed=1)
    spec = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        spec[run], eng, got, wall = drive(
            f"spec_draft_{run}", ("ternary_gemm_decode", "ternary_gemm_tiled",
                                  "decode_attention"),
            graph, draft=(d_cfg, d_model), k_draft=4)
        print(json.dumps({"phase": "speculative", "draft": "bitnet_2b_4t",
                          "k": 4, "run": run, **stats(eng, wall),
                          "share_equal_to_plain": share_equal(spec[run],
                                                              plain),
                          "plain_ms_per_step": plain_stats["ms_per_round"],
                          "launches": got, "card": card}), flush=True)
        del eng
        done()
    if spec["graph"] != spec["eager"]:
        fail("speculative (bitnet_2b_4t draft): graphed rounds' tokens "
             "differ from eager ones")
    del d_model, d_cfg
    done()
    own, eng, got, wall = drive("spec_self_draft", ("ternary_gemm_tiled",),
                                draft=(cfg_t, model_t), k_draft=4)
    print(json.dumps({"phase": "speculative", "draft": "the flagship itself",
                      "k": 4, "run": "graph", **stats(eng, wall),
                      "share_equal_to_plain": share_equal(own, plain),
                      "launches": got, "seconds": time.time() - t_phase}),
          flush=True)
    del eng
    done()

    # 13. lookahead at full width: W 4, G 3 (T 11, M 352 per round)
    t_phase = time.time()
    look = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        look[run], eng, got, wall = drive(
            f"lookahead_{run}", ("ternary_gemm_tiled",), graph,
            lookahead=(4, 3))
        print(json.dumps({"phase": "lookahead", "W": 4, "G": 3, "run": run,
                          **stats(eng, wall),
                          "share_equal_to_plain": share_equal(look[run],
                                                              plain),
                          "launches": got, "card": card,
                          "seconds": time.time() - t_phase}), flush=True)
        del eng
        done()
    if look["graph"] != look["eager"]:
        fail("lookahead: graphed rounds' tokens differ from eager ones")

    # 14. tiny_real on the card and the CPU: draft (itself, and itself with
    # its last layer dropped), lookahead, prompt lookup through the CLI, a
    # GBNF and a json_schema request, a LoRA and a control vector
    t_phase = time.time()
    cfg_r, gpu_r, cpu_r = real[0], real[1], real[2]
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(fixture)
    eos = tok.eos_id
    texts = [b"The little model", b"reads the lines", b"of its own repo.",
             b"The", b"little model reads the lines of its own repo.", b"re"]
    gbnf = 'root ::= "The " [a-z]+ (" " [a-z]+)* "."'
    schema = {"type": "object", "properties": {"a": {"type": "integer"},
                                               "b": {"type": "string",
                                                     "maxLength": 6}},
              "required": ["a", "b"]}

    def dropped(model):
        cfg_d = dataclasses.replace(cfg_r, n_layers=cfg_r.n_layers - 1)
        tree = model.tree()
        tree["layers"] = {k: ({kk: vv[:-1] for kk, vv in v.items()}
                              if isinstance(v, dict) else v[:-1])
                          for k, v in tree["layers"].items()}
        return cfg_d, TransformerLM(cfg_d, tree)

    rng = np.random.default_rng(5)
    adapter = scratch / "tiny_lora"
    adapter.mkdir()
    d, q, kv, ff = cfg_r.d_model, cfg_r.q_dim, cfg_r.kv_dim, cfg_r.d_ff
    arrays = {}
    for li in range(cfg_r.n_layers):
        for mod, block, k, n in (("q_proj", "self_attn", d, q),
                                 ("v_proj", "self_attn", d, kv),
                                 ("o_proj", "self_attn", q, d),
                                 ("up_proj", "mlp", d, ff),
                                 ("down_proj", "mlp", ff, d)):
            pre = f"base_model.model.model.layers.{li}.{block}.{mod}"
            arrays[f"{pre}.lora_A.weight"] = (
                rng.standard_normal((8, k)) * 0.05).astype(np.float32)
            arrays[f"{pre}.lora_B.weight"] = (
                rng.standard_normal((n, 8)) * 0.05).astype(np.float32)
    write_safetensors(adapter / "adapter_model.safetensors", arrays)
    (adapter / "adapter_config.json").write_text(
        json.dumps({"r": 8, "lora_alpha": 16}))
    cvec = (rng.standard_normal((cfg_r.n_layers, cfg_r.d_model))
            * 0.3).astype(np.float32)

    def tiny(model, mode):
        kw, m = {}, model
        if mode == "draft_self":
            kw = dict(draft=(cfg_r, model), k_draft=3)
        elif mode == "draft_dropped":
            kw = dict(draft=dropped(model), k_draft=3)
        elif mode == "lookahead":
            kw = dict(lookahead=(4, 3))
        elif mode == "lora":
            m = lora.apply_lora(model, lora.load_peft_adapter(adapter, cfg_r),
                                scale=1.0)
        elif mode == "cvector":
            m = lora.apply_cvector(model, cvec, scale=1.0)
        eng = Engine(cfg_r, m, n_slots=4, max_len=256, **kw)
        grams = [None] * len(texts)
        if mode == "grammar":
            grams[0] = tok.make_grammar(gbnf)
            grams[3] = tok.make_grammar(gm.json_schema_to_gbnf(schema))
        reqs = [Request(prompt=[2] + list(t), max_new_tokens=16,
                        sampler=greedy, stop_tokens=(eos,), grammar=g)
                for t, g in zip(texts, grams)]
        eng.run(reqs)
        return [r.output for r in reqs], eng.perf

    reset()
    modes = ("plain", "draft_self", "draft_dropped", "lookahead", "grammar",
             "lora", "cvector")
    card_out = {mode: tiny(gpu_r, mode) for mode in modes}
    got = read("tiny_real_slice", ("ternary_gemm_decode",
                                   "ternary_gemm_fused_quant",
                                   "decode_attention"))
    cpu_out = {mode: tiny(cpu_r, mode) for mode in modes}
    for mode in modes:
        if card_out[mode][0] != cpu_out[mode][0]:
            fail(f"tiny_real {mode}: card tokens differ from the CPU's")
    for mode in ("draft_self", "draft_dropped", "lookahead"):
        if card_out[mode][0] != card_out["plain"][0]:
            fail(f"tiny_real {mode}: tokens differ from plain greedy")
        if not card_out[mode][1].n_spec_rounds:
            fail(f"tiny_real {mode}: no round ran")
    if card_out["draft_self"][1].n_spec_accepted != card_out["draft_self"][
            1].n_spec_drafted:
        fail("tiny_real as its own draft: a proposal was rejected")
    for i, g in ((0, gm.Grammar.from_gbnf(gbnf)),
                 (3, gm.Grammar.from_gbnf(gm.json_schema_to_gbnf(schema)))):
        out = card_out["grammar"][0][i]
        text = "".join(tok.pieces()[t] for t in out if t != eos)
        if not gm.GrammarState(g).accepts_text_prefix(text):
            fail(f"tiny_real grammar request {i}: {text!r} is not accepted "
                 "by its grammar")
    for mode in ("lora", "cvector"):
        if card_out[mode][0] == card_out["plain"][0]:
            fail(f"tiny_real {mode}: the adapter changed no token")

    def cli_text(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(
                io.StringIO()):
            cli.main(argv)
        return buf.getvalue()

    base = ["generate", "--model", str(fixture), "-p",
            "The little model reads the lines", "-n", "16", "--temp", "0"]
    lookup = {d_: cli_text(base + ["--prompt-lookup", "3", "--device", d_])
              for d_ in ("cuda", "cpu")}
    plain_cli = cli_text(base + ["--device", "cuda"])
    print(json.dumps({
        "phase": "tiny_real_slice",
        "tokens": {m: card_out[m][0][0] for m in modes},
        "spec_rounds": {m: card_out[m][1].n_spec_rounds for m in modes},
        "accepted": {m: card_out[m][1].n_spec_accepted for m in modes},
        "grammar_texts": ["".join(tok.pieces()[t] for t in card_out[
            "grammar"][0][i] if t != eos) for i in (0, 3)],
        "cli_prompt_lookup": lookup["cuda"], "cli_plain": plain_cli,
        "launches": got, "seconds": time.time() - t_phase}), flush=True)
    if lookup["cuda"] != lookup["cpu"]:
        fail("CLI prompt lookup: card text differs from the CPU's")
    if not lookup["cuda"].startswith(plain_cli.rstrip("\n")):
        fail("CLI prompt lookup: text differs from plain greedy generate")

    # 15. grammar at full width: 8 slots of the flagship, a JSON schema
    # over a synthetic 128,256-piece vocabulary made from the seed
    t_phase = time.time()
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789 {}\":,.-_")
    rng = np.random.default_rng(11)
    v = cfg_t.vocab_size
    lens_ = rng.integers(1, 7, v)
    pieces = ["".join(rng.choice(alphabet, int(n_))) for n_ in lens_]
    pieces[3:3 + len(alphabet)] = alphabet  # every character alone too
    eos_f = 128001
    for i in (0, 1, 2, eos_f):
        pieces[i] = ""
    t0 = time.perf_counter()
    trie = gm.VocabTrie(pieces)
    trie_s = time.perf_counter() - t0
    schema_f = {"type": "object",
                "properties": {"name": {"type": "string", "maxLength": 8},
                               "n": {"type": "integer"}},
                "required": ["name", "n"]}
    gbnf_f = gm.json_schema_to_gbnf(schema_f)
    outs_g = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        reqs = [Request(prompt=r.prompt, max_new_tokens=16, sampler=greedy,
                        stop_tokens=(eos_f,),
                        grammar=gm.GrammarSampler(gbnf_f, pieces,
                                                  eos_ids=(eos_f,),
                                                  trie=trie))
                for r in requests(n=8, lo=64, hi=256, new=16, seed=4)]
        outs_g[run], eng, got, wall = drive(
            f"grammar_{run}", ("ternary_gemm_decode", "decode_attention"),
            graph, n_slots=8, reqs=reqs)
        p = eng.perf
        steps = max(p.n_decode_steps, 1)
        print(json.dumps({
            "phase": "grammar", "run": run, "slots": 8,
            "vocab_pieces": len(pieces), "trie_build_s": trie_s,
            "decode_steps": p.n_decode_steps,
            "host_mask_ms_per_step": 1e3 * p.t_grammar_s / steps,
            "step_ms_without_masks": 1e3 * (p.t_decode_s - p.t_grammar_s)
            / steps,
            "texts": ["".join(pieces[t] for t in o if t != eos_f)
                      for o in outs_g[run][:3]],
            "step_programs": eng.step_programs(), "launches": got,
            "card": card, "seconds": time.time() - t_phase}), flush=True)
        del eng
        done()
    if outs_g["graph"] != outs_g["eager"]:
        fail("grammar at full width: graphed tokens differ from eager ones")
    g_f = gm.Grammar.from_gbnf(gbnf_f)
    for o in outs_g["graph"]:
        text = "".join(pieces[t] for t in o if t != eos_f)
        if not gm.GrammarState(g_f).accepts_text_prefix(text):
            fail(f"grammar at full width: {text!r} is not accepted")

    # 16. LoRA at full width: a random rank-16 adapter on wq/wv/w_up (the
    # unfused tree, #4 per projection at decode), 32 slots, against the
    # fused model's step
    t_phase = time.time()
    rng = np.random.default_rng(6)
    adapter_f = scratch / "flagship_lora"
    adapter_f.mkdir()
    arrays = {}
    for li in range(cfg_t.n_layers):
        for mod, block, k, n in (("q_proj", "self_attn", 4096, 4096),
                                 ("v_proj", "self_attn", 4096, 1024),
                                 ("up_proj", "mlp", 4096, 14336)):
            pre = f"base_model.model.model.layers.{li}.{block}.{mod}"
            arrays[f"{pre}.lora_A.weight"] = (
                rng.standard_normal((16, k)) * 0.02).astype(np.float32)
            arrays[f"{pre}.lora_B.weight"] = (
                rng.standard_normal((n, 16)) * 0.02).astype(np.float32)
    write_safetensors(adapter_f / "adapter_model.safetensors", arrays)
    (adapter_f / "adapter_config.json").write_text(
        json.dumps({"r": 16, "lora_alpha": 32}))
    del arrays
    base_m = quantize_head(init_params_fast(cfg_t, seed=0, device=dev))
    lmodel = lora.apply_lora(base_m, lora.load_peft_adapter(adapter_f, cfg_t))
    del base_m
    lreqs = lambda: requests(n=32, lo=64, hi=256, new=16, seed=3)  # noqa: E731
    _, eng, _, wall = drive("lora_base_fused", ("ternary_gemm_decode",),
                            reqs=lreqs())
    fused_stats = stats(eng, wall)
    del eng
    done()
    outs_l = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        outs_l[run], eng, got, wall = drive(
            f"lora_{run}", ("ternary_gemm_fused_quant", "ternary_gemm_decode",
                            "ternary_gemm_tiled"), graph, model=lmodel,
            reqs=lreqs())
        st = stats(eng, wall)
        per = [p_ for p_ in st["step_programs"] if p_.get("replays")]
        print(json.dumps({
            "phase": "lora", "rank": 16, "on": ["wq", "wv", "w_up"],
            "run": run, "ms_per_step": st["ms_per_round"],
            "fused_model_ms_per_step": fused_stats["ms_per_round"],
            "fused_quant_launches_per_step": (
                per[0]["launches_per_replay"].get("ternary_gemm_fused_quant")
                if per else None),
            "step_programs": st["step_programs"], "launches": got,
            "card": card, "seconds": time.time() - t_phase}), flush=True)
        del eng
        done()
    if outs_l["graph"] != outs_l["eager"]:
        fail("LoRA at full width: graphed tokens differ from eager ones")
    del lmodel
    done()

    # 17. slot save/restore on the flagship engine: a slot saved after its
    # request, erased, restored into another slot of the captured engine;
    # the continuation equals the one from the slot it was saved from
    t_phase = time.time()
    rng = np.random.default_rng(8)
    prompt = [int(t) for t in rng.integers(3, cfg_t.vocab_size, 300)]
    suffix = [int(t) for t in rng.integers(3, cfg_t.vocab_size, 8)]

    def continuation(restore):
        reset()
        eng = Engine(cfg_t, model_t, n_slots=4, max_len=2048)
        eng.run([Request(prompt=prompt, max_new_tokens=6, sampler=greedy)])
        hist = list(eng.slots[0].history)
        size = 0
        if restore:
            t0 = time.perf_counter()
            data = eng.save_slot(0)
            save_s = time.perf_counter() - t0
            eng.slots[0].history = []
            t0 = time.perf_counter()
            eng.restore_slot(2, data)
            torch.cuda.synchronize()
            size = (len(data), save_s, time.perf_counter() - t0)
            if eng.slots[2].history != hist:
                fail("slot restore: history differs")
        nxt = Request(prompt=hist + suffix, max_new_tokens=16,
                      sampler=greedy)
        eng.run([nxt])
        if eng.perf.n_reused_tokens != len(hist):
            fail(f"slot restore: reused {eng.perf.n_reused_tokens} of "
                 f"{len(hist)} rows")
        del eng
        done()
        return nxt.output, size

    orig, _ = continuation(False)
    restored, (n_bytes, save_s, load_s) = continuation(True)
    got = read("slot_restore", ("ternary_gemm_decode",))
    print(json.dumps({"phase": "slot_restore", "rows": len(prompt) + 5,
                      "bytes": n_bytes, "save_s": save_s, "restore_s": load_s,
                      "tokens_restored": restored, "tokens_original": orig,
                      "identical": restored == orig, "launches": got,
                      "seconds": time.time() - t_phase}), flush=True)
    if restored != orig:
        fail("slot restore: the continuation differs from the original's")
    shutil.rmtree(scratch, ignore_errors=True)


def same_checkpoints(a: pathlib.Path, b: pathlib.Path) -> bool:
    """Two converted checkpoints hold the same arrays (name, dtype, shape,
    bytes) and the same ``vlut_config.json``."""
    from vlut_tpu_torch.convert.checkpoint import safetensors_arrays

    x = safetensors_arrays(a / "model.safetensors")
    y = safetensors_arrays(b / "model.safetensors")
    return (sorted(x) == sorted(y)
            and all(x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                    and x[k].tobytes() == y[k].tobytes() for k in x)
            and json.loads((a / "vlut_config.json").read_text())
            == json.loads((b / "vlut_config.json").read_text()))


def written_back(cfg, tree: dict, dst: pathlib.Path, device) -> list[str]:
    """The leaves of the converted checkpoint ``dst`` that differ from the
    HF1BitLLM-layout tree written: packed bytes, embedding, norms and the
    head's columns bit for bit (its padding zero), each scale
    ``np.float32(1) / weight_scale`` of the bf16 ``1 / scale`` written."""
    import numpy as np
    import torch

    from vlut_tpu_torch.convert.checkpoint import read_safetensors

    got = read_safetensors(dst / "model.safetensors", device)
    want: dict = {}

    def flat(node, key=""):
        for k, v in node.items():
            if isinstance(v, dict):
                flat(v, f"{key}{k}.")
            else:
                want[key + k] = v

    flat(tree)
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        g, w = got[k], want[k].to(device)
        if k.endswith(".scale"):
            ws = (1.0 / w).to(torch.bfloat16).float().cpu().numpy()
            w = torch.from_numpy(np.float32(1) / ws).to(device)
        if k == "lm_head":
            if g[:, cfg.vocab_size:].any():
                bad.append(k + " (padding)")
            g, w = g[:, :cfg.vocab_size], w[:, :cfg.vocab_size]
        if (g.dtype != w.dtype or g.shape != w.shape
                or not torch.equal(g.contiguous().view(torch.uint8),
                                   w.contiguous().view(torch.uint8))):
            bad.append(k)
    return bad


def convert_phase(dev, fixture, card, reset, read) -> None:
    """Phase 24: the HF converter.  (a) ``llama3_8b_158`` at full width and
    depth (``init_params_fast``, seed 24) written by ``bench/hf_writer.py``
    in HF1BitLLM's layout to a temporary directory, converted by ``cli
    convert`` on the card, loaded onto the card: every leaf the tree
    written (:func:`written_back`), the config the preset's; served as
    ``bench/flagship.py:build_model`` serves it (int8 head, fused,
    unrolled): fused graphed and eager (identical tokens) and composed
    graphed, each counted (#1, #3, #7; #5); the seconds and GB/s of each
    stage; both directories deleted.  (b) an HF1BitLLM llama, the zoo's
    mixtral and the recurrent zoo's mamba (tiny widths) written by
    ``bench/hf_writer.py``, converted on the card and on the CPU (equal
    checkpoints), each served on the card against the CPU, each card layer
    from the CPU's input (``bench/zoo.py:card_vs_cpu``,
    ``bench/recurrent_zoo.py:card_vs_cpu``).  (c) tiny_real written as an
    HF directory in the float32 layout, ``cli convert`` on the card and
    with ``--device cpu`` (equal), ``cli generate --temp 0`` of each on its
    device: the CPU's text.  (d) The host packer at ``llama3_8b_158``'s
    widths (:func:`native_pack_case`)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import flagship, hf_writer, recurrent_zoo, zoo
    from vlut_tpu_torch.config import PRESETS, ModelConfig
    from vlut_tpu_torch.convert.checkpoint import (load_checkpoint,
                                                   read_safetensors,
                                                   unflatten)
    from vlut_tpu_torch.convert.convert import convert_hf
    from vlut_tpu_torch.models import transformer as tt

    t_phase = time.time()
    preset = "llama3_8b_158"
    cfg = PRESETS[preset]
    out: dict = {"phase": "convert", "model": preset, "card": card}

    def gb(path: pathlib.Path) -> float:
        return sum(f.stat().st_size for f in path.glob("*.safetensors")) / 1e9

    # (a) the flagship in HF1BitLLM's layout, converted on the card
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        t0 = time.time()
        tree = tt.init_params_fast(cfg, seed=24, device=dev).tree()
        torch.cuda.synchronize()
        out["init_s"] = time.time() - t0
        t0 = time.time()
        src = hf_writer.write_hf(d / "hf", cfg, tree, layout="hf1bitllm")
        out["write_s"] = time.time() - t0
        out["hf_gb"] = gb(src)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["convert", str(src), str(d / "out")])
        out["convert_s"] = time.time() - t0
        out["checkpoint_gb"] = gb(d / "out")
        shutil.rmtree(src)
        t0 = time.time()
        cfg2, model, meta = load_checkpoint(d / "out", device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.time() - t0
        for stage, nbytes in (("write", out["hf_gb"]),
                              ("convert", out["hf_gb"]),
                              ("load", out["checkpoint_gb"])):
            out[f"{stage}_gb_per_s"] = nbytes / out[f"{stage}_s"]
        bad = written_back(cfg, tree, d / "out", dev)
        out["leaves_differing"] = bad
        del tree
    if bad:
        fail(f"convert {preset}: leaves differ from the tree written: "
             f"{bad[:8]}")
    if cfg2 != cfg or meta["ternarized_tensors"] != 0:
        fail(f"convert {preset}: config {cfg2} or lossy tensors "
             f"({meta['ternarized_tensors']})")
    torch.cuda.empty_cache()
    model = tt.unstack_layers(tt.fuse_projections(tt.quantize_head(model),
                                                  cfg2), cfg2)
    toks, steps = {}, {}
    for mode, graph, attn_kernel in (
            ("fused", True, "decode_attention"),
            ("fused", False, "decode_attention"),
            ("composed", True, "write_rows_pair")):
        run = f"{mode}_{'graph' if graph else 'eager'}"
        reset()
        fl = flagship.run(preset, device=dev, decode_attn=mode,
                          built=(cfg2, model), cuda_graph=graph, reps=1)
        out.setdefault("launches", {})[run] = read(
            f"convert_flagship_{run}", ("ternary_gemm_decode",
                                        "ternary_gemm_tiled", attn_kernel))
        toks[run] = fl.pop("tokens").cpu()
        steps[run] = fl["ms_per_step"]
    out["ms_per_step"] = steps
    if not torch.equal(toks["fused_graph"], toks["fused_eager"]):
        fail("converted flagship: the graphed step's greedy tokens differ "
             "from the eager step's")
    del model
    torch.cuda.empty_cache()
    out["flagship_s"] = time.time() - t_phase

    # (b) families converted on the card and on the CPU, served card = CPU
    families = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        small = ModelConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=512, head_dim=128,
                            max_seq_len=256)
        moe = zoo.family_config("moe_mixtral")
        mamba_cfg, mamba_tree = recurrent_zoo.family("mamba")
        sources = {
            "hf1bitllm_llama": hf_writer.write_hf(
                d / "llama", small, tt.init_params_fast(
                    small, seed=1, device="cpu").tree(), layout="hf1bitllm"),
            "mixtral": hf_writer.write_hf(d / "mixtral", moe,
                                          zoo.family_tree(moe, 0)),
            "mamba": hf_writer.write_hf(d / "mamba", mamba_cfg, mamba_tree),
        }
        for name, src in sources.items():
            on_card, on_cpu = d / f"{name}_card", d / f"{name}_cpu"
            convert_hf(src, on_card)
            convert_hf(src, on_cpu, device="cpu")
            equal = same_checkpoints(on_card, on_cpu)
            fcfg = load_checkpoint(on_cpu, device="cpu")[0]
            ftree = unflatten(read_safetensors(on_cpu / "model.safetensors"))
            run = (recurrent_zoo.card_vs_cpu if name == "mamba"
                   else zoo.card_vs_cpu)
            res = run(f"converted_{name}", dev, counters=(reset, read),
                      source=(fcfg, ftree))
            families[name] = {"card_equals_cpu_conversion": equal,
                              **{k: res[k] for k in (
                                  "max_rel_logit_err", "greedy_equal",
                                  "within_tol", "launches")}}
            if not (equal and res["within_tol"] and res["greedy_equal"]
                    and res.get("graph_equals_eager", True)):
                fail(f"converted {name}: {families[name]} "
                     f"{res.get('graph_equals_eager')}")
    out["families"] = families

    # (c) tiny_real through cli convert and cli generate, card and CPU
    def text_of(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue().rsplit("\n[", 1)[0]

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        fcfg, fmodel, _ = load_checkpoint(fixture, device="cpu")
        src = hf_writer.write_hf(d / "hf", fcfg, fmodel.tree(),
                                 tokenizer_src=fixture)
        text_of(["convert", str(src), str(d / "card")])
        text_of(["convert", str(src), str(d / "cpu"), "--device", "cpu"])
        equal = same_checkpoints(d / "card", d / "cpu")
        gen = ["generate", "-p", "The little model", "-n", "12", "--temp",
               "0"]
        reset()
        got = text_of(gen + ["--model", str(d / "card")])
        out.setdefault("launches", {})["fixture_generate"] = read(
            "convert_fixture_generate", ("ternary_gemm_decode",))
        want = text_of(gen + ["--model", str(d / "cpu"), "--device", "cpu"])
    out["fixture"] = {"text": want, "card_equals_cpu_conversion": equal,
                      "text_equal": got == want}
    if not (equal and got == want):
        fail(f"tiny_real round trip: {out['fixture']} (card text {got!r})")

    # (d) the host packer at llama3_8b_158's widths
    out["native_pack"] = native_pack_case(dev)
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def native_pack_case(dev) -> dict:
    """Phase 24 (d): the host packer (``convert/native.py``, g++'s build of
    ``csrc/vlut_pack.cpp``) at ``llama3_8b_158``'s widths: two layers'
    projections (wq, wk, wv, wo, w_gate, w_up, w_down) of random trits
    made on the host from seed 24, in i2 and i1, padded as the checkpoint
    lays them out (``pad_weight``, untimed) and packed by ``pack_ternary``
    three ways: the native route on the host (``use_native=True``), torch
    on the host and torch on the card (the padded trits copied there
    first, untimed).  The bytes must be equal, and equal to
    ``pack_weight``'s on the card from the unpadded trits.  Seconds and
    GB/s of each route (padded trit bytes read plus packed bytes written,
    over the seconds; host clock, the card's ending in a sync), and the
    seconds of a build into an empty directory.  On one full-width float matrix (4096 x
    14336 normals x 0.02): ``native.ternarize_absmean`` against
    ``ops/packing.py:ternarize`` (the scales within a relative 4e-6,
    about log2(58.7M) float32 ulps, the bound of numpy's pairwise float32
    mean that the library takes in float64; a trit may differ only where w
    / scale lies within 1e-5 of a rounding boundary, the library
    multiplying by 1 / scale where numpy divides), and ``native.detect_ternary``
    against the converter's exact-ternary check on it and on an exactly
    ternary matrix."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.convert import convert, native
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.models.dims import make_plan
    from vlut_tpu_torch.ops import _build, packing

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        _build.build(native.SOURCE, pathlib.Path(d))
        build_s = time.perf_counter() - t0
    native.get_lib()
    base = PRESETS["llama3_8b_158"]
    d, hq, hkv, ff = base.d_model, base.n_heads, base.n_kv_heads, base.d_ff
    hd = base.head_dim or d // hq
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d), "w_gate": (d, ff), "w_up": (d, ff),
              "w_down": (ff, d)}
    rng = np.random.default_rng(24)
    routes = ("native_host", "torch_host", "torch_card")
    res = {}
    for fmt in ("i2", "i1"):
        cfg = dataclasses.replace(base, weight_fmt=fmt)
        sec = dict.fromkeys(routes, 0.0)
        nbytes = 0
        kb = make_plan(cfg).kb
        for layer in range(2):
            for name, (k, n) in shapes.items():
                trits = rng.integers(-1, 2, (k, n), dtype=np.int8)
                padded = np.ascontiguousarray(tt.pad_weight(name, trits, cfg))
                on_card = torch.from_numpy(padded).to(dev)
                torch.cuda.synchronize()
                packed = {}
                for route in routes:
                    t0 = time.perf_counter()
                    t = packing.pack_ternary(
                        on_card if route == "torch_card" else padded, 0.5,
                        fmt, kb, use_native=route == "native_host")
                    if route == "torch_card":
                        torch.cuda.synchronize()
                    sec[route] += time.perf_counter() - t0
                    packed[route] = t.packed.cpu()
                packed["pack_weight_card"] = tt.pack_weight(
                    name, torch.from_numpy(trits).to(dev), 0.5, cfg
                ).packed.cpu()
                nbytes += padded.size + packed["native_host"].numel()
                for route in packed:
                    if not torch.equal(packed[route], packed["native_host"]):
                        fail(f"native packer: {fmt} layer {layer} {name}: "
                             f"{route}'s bytes differ from the native route's")
                del on_card
        res[fmt] = {"bytes": nbytes, **{
            r: {"seconds": sec[r], "gb_per_s": nbytes / sec[r] / 1e9}
            for r in routes}}
    w = (rng.standard_normal((d, ff), dtype=np.float32) * 0.02
         ).astype(np.float32)
    t0 = time.perf_counter()
    tn, sn = native.ternarize_absmean(w)
    tern_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp, sp = packing.ternarize(w)
    numpy_s = time.perf_counter() - t0
    diff = tn != tp
    ratio = np.abs(w[diff]) / np.float32(sp)
    edge = np.minimum(np.abs(ratio - 0.5), np.abs(ratio - 1.5))
    exact = (rng.integers(-1, 2, (d, d)).astype(np.float32)
             * np.float32(0.05))
    detect = {"float": native.detect_ternary(w),
              "exact": native.detect_ternary(exact)}
    checks = {"float": convert._is_exact_ternary(w),
              "exact": convert._is_exact_ternary(exact)}
    res["ternarize"] = {
        "native_scale": float(sn), "numpy_scale": float(sp),
        "trits_differing": int(diff.sum()),
        "largest_boundary_distance": float(edge.max()) if diff.any() else 0.0,
        "native_s": tern_s, "numpy_s": numpy_s,
        "detect_ternary": detect,
        "exact_check": {k: list(v) for k, v in checks.items()}}
    if (abs(float(sn) - float(sp)) > 4e-6 * float(sp)
            or (diff.any() and float(edge.max()) > 1e-5)):
        fail(f"native ternarize_absmean: {res['ternarize']}")
    if not (detect["float"] == -1.0 and not checks["float"][0]
            and checks["exact"][0] and detect["exact"] == checks["exact"][1]
            == np.float32(0.05)):
        fail(f"native detect_ternary: {detect} against {checks}")
    res["build_s"] = build_s
    print(json.dumps({"phase": "convert", "native_pack": res}), flush=True)
    return res


def family_back(cfg, tree: dict, dst: pathlib.Path) -> list[str]:
    """The leaves of a float family's converted checkpoint ``dst`` that
    differ from the tree written (bit for bit), and "config" if its config
    is not ``cfg``."""
    import torch

    from vlut_tpu_torch.convert.checkpoint import read_tree

    got_cfg, got, _ = read_tree(dst)

    def leaves(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{key}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from leaves(v, f"{key}.{i}")
        else:
            yield key, node

    want, have = dict(leaves(tree)), dict(leaves(got))
    bad = sorted(set(want) ^ set(have))
    bad += [k for k in set(want) & set(have)
            if want[k].dtype != have[k].dtype
            or not torch.equal(want[k], have[k])]
    return bad + (["config"] if got_cfg != cfg else [])


def train_phase(dev, card, reset, read) -> None:
    """Phase 25: the trainer and the family converters.  (a)
    ``bitnet_2b_4t`` at its published widths (``init_params_fast``, seed
    25): its float32 twin on the card (``train/finetune.py``), three QAT
    steps of ``torch.optim.AdamW`` on one seeded batch of 4 x 256 tokens
    and a fourth under the profiler (the loss finite and falling),
    ``pack_params`` (two projections' bytes
    and scales, at the first and the last layer, equal to ``pack_params``
    on the CPU for the same masters), saved, loaded and served as
    ``bench/flagship.py:build_model`` serves (int8 head, fused, unrolled)
    through the slot engine, fused graphed and eager (identical tokens)
    and composed graphed, each counted (#1, #3, #7; #5).  (b) one case of each family converter (T5,
    gemma3n, bert, RWKV7, the jamba hybrid; random trees of
    ``bench/encoder_zoo.py`` / ``bench/recurrent_zoo.py``) written by
    ``bench/hf_writer.py``, converted on the card and on the CPU (equal
    checkpoints, each the tree written) and served on the card against
    the CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import (encoder_zoo, flagship, hf_writer,
                                      recurrent_zoo)
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.convert.checkpoint import (load_checkpoint,
                                                   read_safetensors,
                                                   read_tree,
                                                   save_checkpoint)
    from vlut_tpu_torch.convert.convert import convert_hf
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.train import finetune as ft

    t_phase = time.time()
    preset = "bitnet_2b_4t"
    cfg = PRESETS[preset]
    out: dict = {"phase": "train", "model": preset, "card": card}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (a) the float32 twin, four QAT steps, the repack
    t0 = time.time()
    params = ft.trainable(ft.float_twin_params(
        tt.init_params_fast(cfg, seed=25, device=dev), cfg))
    torch.cuda.synchronize()
    out["twin_s"] = time.time() - t0
    masters = ft.leaves(params)
    out["master_params"] = sum(t.numel() for t in masters)
    out["master_gb"] = sum(t.numel() * t.element_size()
                           for t in masters) / 1e9
    opt = torch.optim.AdamW(masters, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = ft.make_train_step(cfg, opt, qat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    tokens = torch.randint(3, cfg.vocab_size, (4, 256), generator=gen,
                           device=dev)
    mask = torch.ones_like(tokens, dtype=torch.bool)
    losses, step_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(params, tokens, mask)
        b.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        step_ms.append(a.elapsed_time(b))
    out.update(batch=[4, 256], losses=losses, step_ms=step_ms,
               train_tok_per_s=[4 * 256 / (ms / 1e3) for ms in step_ms],
               peak_train_gb=torch.cuda.max_memory_allocated() / 1e9)
    # a fourth step under the profiler: device time by kernel, idle share
    out["profile_step"] = flagship.profile_decode(
        lambda: losses.append(float(step(params, tokens, mask))), 1)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{preset} QAT: the loss is not finite and falling: {losses}")
    del opt, step, masters, loss
    torch.cuda.empty_cache()
    t0 = time.time()
    packed = ft.pack_params(params, cfg)
    torch.cuda.synchronize()
    out["pack_s"] = time.time() - t0
    which = [0, cfg.n_layers - 1]
    on_cpu = ft.pack_params({"layers": {
        nm: {"dense": params["layers"][nm]["dense"][which].detach().cpu()}
        for nm in ("wq", "w_down")}}, cfg)
    differ = [f"{nm}.{leaf}" for nm in ("wq", "w_down")
              for leaf in ("packed", "scale")
              if not torch.equal(on_cpu["layers"][nm][leaf],
                                 packed["layers"][nm][leaf][which].cpu())]
    out["pack_card_equals_cpu"] = not differ
    if differ:
        fail(f"{preset}: pack_params on the card differs from the CPU's at "
             f"{differ}")
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.time()
        save_checkpoint(d, cfg, packed)
        cfg2, model, _ = load_checkpoint(d, device=dev)
        torch.cuda.synchronize()
        out["save_load_s"] = time.time() - t0
        back = read_safetensors(pathlib.Path(d) / "model.safetensors", dev)
        if not all(torch.equal(back[f"layers.{nm}.packed"],
                               packed["layers"][nm]["packed"])
                   for nm in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                              "w_down")):
            fail(f"{preset}: the saved checkpoint is not the packed tree")
        del back
    del packed
    model = tt.unstack_layers(tt.fuse_projections(tt.quantize_head(model),
                                                  cfg2), cfg2)
    toks = {}
    for mode, graph, attn_kernel in (
            ("fused", True, "decode_attention"),
            ("fused", False, "decode_attention"),
            ("composed", True, "write_rows_pair")):
        run = f"{mode}_{'graph' if graph else 'eager'}"
        reset()
        res = bench_engine.run(
            device=dev, built=(cfg2, model), n_slots=8, ctx=1024,
            requests=bench_engine.make_requests(cfg2.vocab_size, n=12,
                                                hi=512, new_tokens=16,
                                                seed=25),
            decode_attn=mode, cuda_graph=graph)
        out.setdefault("launches", {})[run] = read(
            f"train_{preset}_engine_{run}",
            ("ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
        toks[run] = res.pop("outputs")
        out.setdefault("engine", {})[run] = {
            k: res[k] for k in ("prompt_tokens", "prompt_tok_per_s",
                                "decode_tok_per_s", "decode_ms_per_step",
                                "replay_ms_per_step")}
    out["graph_equals_eager"] = toks["fused_graph"] == toks["fused_eager"]
    if not out["graph_equals_eager"]:
        fail(f"trained {preset}: the graphed step's greedy tokens differ "
             "from the eager step's")
    del model
    torch.cuda.empty_cache()
    out["bitnet_s"] = time.time() - t_phase

    # (b) one case of each family converter, card against CPU
    families = {}
    cases = {"t5": (encoder_zoo, "t5_gated"),
             "gemma3n": (encoder_zoo, "gemma3n"),
             "encoder": (encoder_zoo, "bert"),
             "rwkv7": (recurrent_zoo, "rwkv7"),
             "hybrid": (recurrent_zoo, "jamba")}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        for label, (zoo_mod, name) in cases.items():
            fcfg, tree = zoo_mod.family(name, seed=25)
            src = hf_writer.write_hf(d / label, fcfg, tree)
            convert_hf(src, d / f"{label}_card")
            convert_hf(src, d / f"{label}_cpu", device="cpu")
            equal = same_checkpoints(d / f"{label}_card", d / f"{label}_cpu")
            bad = family_back(fcfg, tree, d / f"{label}_card")
            res = zoo_mod.card_vs_cpu(f"converted_{name}", dev,
                                      source=read_tree(d / f"{label}_card")[
                                          :2])
            same = res.get("greedy_equal", res.get("equal"))
            families[label] = {"family": name,
                               "card_equals_cpu_conversion": equal,
                               "leaves_differing": bad,
                               "within_tol": res["within_tol"],
                               "equal": same,
                               **{k: res[k] for k in (
                                   "max_rel_logit_err", "max_rel_err")
                                  if k in res}}
            if not (equal and not bad and res["within_tol"] and same):
                fail(f"converted {label}: {families[label]}")
            shutil.rmtree(src)
    out["families"] = families
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def vision_phase(dev, fixture, card, reset, read) -> None:
    """Phase 26: the vision half.  (a) ``llava_1_5_7b`` at full width and
    depth (``bench/vision_zoo.py:llava_1_5_7b``): the tower from
    ``vision.init_params_fast`` (seed 26, bf16), the text from
    ``bench/flagship.py:build_model`` (seed 26: packed i2, int8 head,
    fused, unrolled); a seeded 336 x 336 array through
    ``preprocess_image``, the tower and the projector, each timed; then
    ``cli.describe`` of :data:`LLAVA_PROMPT` with tiny_real's tokenizer
    (no end-of-sequence stop): the prefill alone and 33 tokens (the
    prefill's and 32 graphed decode steps') timed, fused (counted: #3, #1,
    #7) twice with identical tokens, 65 tokens (the marginal token's time,
    set-up and capture cancelled), eager (the graphed run's tokens),
    then composed (counted: #5) graphed and eager with identical tokens;
    the tower, the prefill and the 33-token run profiled.  (b) every
    family of ``bench/vision_zoo.py``, card against CPU, each splice
    counted (``vision_zoo.splice_kernels``)."""
    import types

    import numpy as np
    import torch

    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.bench import vision_zoo as vz
    from vlut_tpu_torch.cli import describe
    from vlut_tpu_torch.models import vision as pv
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    t_phase = time.time()
    vcfg, cfg = vz.llava_1_5_7b()
    out: dict = {"phase": "vision", "model": "llava_1_5_7b", "card": card}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    _, model = flagship.build_model("llava_1_5_7b", dev, seed=26)
    vp = pv.init_params_fast(vcfg, seed=26, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.time() - t0
    out["tower_params"] = (sum(v.numel() for v in vp["layers"].values())
                           + sum(v.numel() for k, v in vp.items()
                                 if k != "layers"))
    img = np.random.default_rng(26).random((336, 336, 3)).astype(np.float32)
    x = torch.from_numpy(pv.preprocess_image(img, vcfg.image_size)).to(
        dev)[None]
    with torch.inference_mode():
        feats = pv.encode_tower(vp, vcfg, x)
        embeds = pv.llava_project(vp, feats)[0]
        out["tower_ms"] = cuda_ms(lambda: pv.encode_tower(vp, vcfg, x),
                                  iters=3, warmup=1)
        out["projector_ms"] = cuda_ms(lambda: pv.llava_project(vp, feats),
                                      iters=5, warmup=1)
    if embeds.shape != (576, cfg.d_model) or not torch.isfinite(
            embeds.float()).all():
        fail(f"llava_1_5_7b: image rows {tuple(embeds.shape)}, finite "
             f"{bool(torch.isfinite(embeds.float()).all())}")
    tok = Tokenizer(fixture)
    shim = types.SimpleNamespace(encode=tok.encode, eos_id=None)

    def timed(n, mode="fused", graph=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = describe(model, cfg, shim, embeds, LLAVA_PROMPT, n,
                        decode_attn=mode, cuda_graph=graph)
        torch.cuda.synchronize()
        return toks, (time.perf_counter() - t) * 1e3

    timed(3)  # warm-up: each kernel shape's first launch, one capture
    _, out["prefill_ms"] = timed(1)
    reset()
    first, ms33 = timed(33)
    out["launches"] = {"fused": read("vision_llava_1_5_7b_fused", (
        "ternary_gemm_tiled", "ternary_gemm_decode", "decode_attention"))}
    out["ms_per_token"] = (ms33 - out["prefill_ms"]) / 32
    second, _ = timed(33)
    # the marginal token of a longer run: the prefill, the first (eager)
    # step and the capture cancel
    # the marginal token of a longer run (96 more graph replays; the
    # prefill, the eager first step and the capture cancel)
    _, ms129 = timed(129)
    out["marginal_ms_per_token"] = (ms129 - ms33) / 96
    eager, ms33_eager = timed(33, graph=False)
    out["eager_ms_per_token"] = (ms33_eager - out["prefill_ms"]) / 32
    reset()
    composed, ms33_c = timed(33, "composed")
    out["composed_ms_per_token"] = (ms33_c - out["prefill_ms"]) / 32
    out["launches"]["composed"] = read("vision_llava_1_5_7b_composed", (
        "ternary_gemm_tiled", "ternary_gemm_decode", "write_rows_pair"))
    composed_eager, _ = timed(33, "composed", graph=False)
    out.update(prefill_rows=llava_prefill_m(), tokens=first,
               runs_identical=first == second, graph_equals_eager=(
                   first == eager), composed_graph_equals_eager=(
                   composed == composed_eager),
               composed_equal_share=sum(a == b for a, b in zip(
                   first, composed)) / len(first),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if len(first) != 33 or first != second:
        fail(f"llava_1_5_7b: two describe runs differ ({first} / {second})")
    if first != eager:
        fail(f"llava_1_5_7b: graphed decode {first} != eager {eager}")
    if composed != composed_eager:
        fail(f"llava_1_5_7b: graphed composed decode {composed} != eager "
             f"{composed_eager}")
    # where the time goes: the tower, the prefill, and the 33-token run
    # (its decode = the run less the prefill), each under the profiler
    with torch.inference_mode():
        out["tower_profile"] = flagship.profile_decode(
            lambda: pv.encode_tower(vp, vcfg, x), 1)
    out["prefill_profile"] = flagship.profile_decode(lambda: timed(1), 1)
    run33 = flagship.profile_decode(lambda: timed(33), 33)
    kern_ms = (33 * run33["kernel_ms_per_step"]
               - out["prefill_profile"]["kernel_ms_per_step"]) / 32
    wall_ms = (33 * run33["wall_ms_per_step"]
               - out["prefill_profile"]["wall_ms_per_step"]) / 32
    out["decode_profile"] = {
        "kernel_ms_per_token": kern_ms, "wall_ms_per_token": wall_ms,
        "idle_share": 1.0 - kern_ms / wall_ms, "run33": run33}
    del model, vp, feats, embeds
    torch.cuda.empty_cache()
    out["llava_s"] = time.time() - t_phase

    # (b) every vision family, card against CPU
    families = {}
    for name in vz.FAMILIES:
        r = vz.card_vs_cpu(name, dev, counters=(reset, read), seed=26)
        families[name] = r
        if not r["ok"]:
            fail(f"vision family {name}: {r}")
    keep = ("tower_rel_err", "splice", "splice_skipped", "launches",
            "differing", "seconds")
    out["families"] = {n: {k: r[k] for k in keep if k in r}
                       for n, r in families.items()}
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def audio_cli_case(dev, fixture, reset, read) -> dict:
    """``cli convert-audio`` -> ``cli describe --audio`` and ``cli
    convert-vocoder`` -> ``cli tts`` on tiny_real, on the card and on the
    CPU: an ultravox source and a WavTokenizer source written from seeded
    arrays (``bench/audio_zoo.py``), converted on both (equal arrays); the
    card's printed text is the CPU's and its WAV within one 16-bit step of
    the CPU's.  The CLI runs under PyTorch's default TF32 settings (cuDNN's
    on), as a user runs it, not under the script's."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import numpy as np

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import audio_zoo as az
    from vlut_tpu_torch.device import tf32
    from vlut_tpu_torch.runtime.tts import save_wav

    def run(argv, device) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + ["--device", str(device)])
        return buf.getvalue()

    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        az.write_ultravox_source(d / "hf_audio", dataclasses.replace(
            az.TINY, d_llm=128), seed=27, proj_hidden=24)
        az.write_wavtokenizer_source(d / "hf_voc", dataclasses.replace(
            az.TINY_VOCODER, vocab_size=256), seed=27)
        rng = np.random.default_rng(27)
        save_wav(str(d / "a.wav"), (0.3 * np.sin(np.arange(16000) * 0.07)
                                    + 0.05 * rng.standard_normal(16000)
                                    ).astype(np.float32), 16000)
        text, wav = {}, {}
        with tf32(conv=True):
            for device in ("cpu", dev):
                tag = "card" if device == dev else "cpu"
                run(["convert-audio", str(d / "hf_audio"),
                     str(d / f"enc_{tag}"), "--d-llm", "128"], device)
                run(["convert-vocoder", str(d / "hf_voc"),
                     str(d / f"voc_{tag}")], device)
                if device == dev:
                    reset()
                text[tag] = run(["describe", "--model", str(fixture),
                                 "--audio", str(d / "a.wav"),
                                 "--audio-encoder", str(d / f"enc_{tag}"),
                                 "-p", "The <audio> little", "-n", "12"],
                                device)
                run(["tts", "--model", str(fixture), "--vocoder",
                     str(d / f"voc_{tag}"), "-p",
                     "The little model, 2 times.", "--guide-tokens", "-n",
                     "48", "--seed", "27", "--code-offset", "0", "-o",
                     str(d / f"{tag}.wav")], device)
                if device == dev:
                    out["launches"] = read("audio_cli_tiny_real", (
                        "ternary_gemm_decode", "decode_attention"))
                wav[tag] = np.frombuffer(
                    (d / f"{tag}.wav").read_bytes()[44:], "<i2"
                ).astype(np.int32)
        for kind in ("enc", "voc"):
            name = "audio.npz" if kind == "enc" else "vocoder.npz"
            a, b = (np.load(d / f"{kind}_{t}" / name) for t in ("card", "cpu"))
            out[f"{kind}_files_equal"] = a.files == b.files and all(
                np.array_equal(a[k], b[k]) for k in a.files)
    out.update(describe_text=text["cpu"].strip(),
               describe_equal=text["card"] == text["cpu"],
               wav_samples=int(wav["cpu"].size),
               wav_max_step=int(np.abs(wav["card"] - wav["cpu"]).max())
               if wav["card"].shape == wav["cpu"].shape else None)
    out["ok"] = (out["enc_files_equal"] and out["voc_files_equal"]
                 and out["describe_equal"] and wav["cpu"].size > 0
                 and out["wav_max_step"] is not None
                 and out["wav_max_step"] <= 1)
    return out


def tts_attention_paths(cfg, model, ids, first: int, dev) -> dict:
    """bench/engine.py:compare_paths at a TTS step: the prompt prefilled
    into a one-slot cache of min(8192, max_seq_len) rows, as
    runtime/tts.py:generate_codes fills it, then the first generated
    token at its position."""
    import torch

    from vlut_tpu_torch.bench.engine import compare_paths
    from vlut_tpu_torch.models.transformer import (
        forward, fuse_projections, init_kv_cache, unstack_layers)

    m2 = unstack_layers(fuse_projections(model, cfg), cfg)
    cache = init_kv_cache(cfg, 1, max_len=min(8192, cfg.max_seq_len),
                          device=dev)
    t = len(ids)
    with torch.inference_mode():
        forward(m2, cfg, torch.tensor([ids], device=dev),
                torch.arange(t, device=dev)[None], cache,
                logits_at=torch.tensor([t - 1], device=dev))
        return compare_paths(m2, cfg, torch.tensor([[first]], device=dev),
                             torch.tensor([[t]], device=dev), cache)


def audio_phase(dev, built, fixture, card, reset, read) -> None:
    """Phase 27: the audio half.  (a) ``describe --audio`` at full width:
    the whisper-large-v3 encoder and ultravox projector at ``AudioConfig``'s
    defaults (float32, ``audio.init_params_fast`` seed 27) into phase 3's
    ``llama3_8b_158`` (seed 0); a seeded 16 kHz WAV of whisper's 3000
    frames (29.99 s: a whole 30 s chunk's 3001st frame overflows the 1500
    learned positions, as in the JAX package) through ``save_wav`` ->
    ``load_wav`` -> ``log_mel`` -> ``encode`` (188 rows) and
    ``cli.describe`` of ``audio_zoo.AUDIO_PROMPT`` (tiny_real's tokenizer,
    no end-of-sequence stop): 33 greedy tokens fused (counted: #3, #1, #7)
    twice, 129 (the marginal token), eager, then composed (counted: #5)
    graphed and eager; the log-mel (host clock), tower, projector, prefill
    and token times and a profile of the decode.  (b) ``tts`` at full
    width: ``outetts_0_2_500m`` (seed 27, packed i2; its q/k/v biases keep
    it unfused: #4 and #1 per step, and #7 over its 14 heads of 64 (padded
    to 128) over 2, 24 launches a step, no #5) and
    the WavTokenizer vocoder at ``VocoderConfig``'s defaults (seed 27); a
    seeded speaker profile of 20 words, ``audio_zoo.TTS_TEXT``
    (``audio_zoo.outetts_tokenizer``: each code, duration and markup one
    token, as OuteTTS-0.2's vocabulary has them), guide tokens, top-k 4,
    256 tokens, seed 27: two graphed runs give one stream
    (the first counted) and an eager run of 32 its first 32 tokens; the
    prefill's ms, each graphed step's ms and each host sampling's ms apart,
    a replay's device ms and a profile of 8 replays; the same step composed
    (#5, 64 tokens) timed and profiled beside it, and the fused step's
    layers held to the composed one's (:func:`tts_attention_paths`,
    ``bench/engine.py:paths_ok``); then ``codes_to_audio`` of 750 seeded codes (10 s) with the
    vocoder's and the ISTFT's times.  (c) ``bench/audio_zoo.py``: each
    family card against CPU, and the CLI end to end on tiny_real
    (:func:`audio_cli_case`)."""
    import statistics
    import tempfile
    import types

    import numpy as np
    import torch

    from vlut_tpu_torch.bench import audio_zoo as az
    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.cli import describe
    from vlut_tpu_torch.device import tf32
    from vlut_tpu_torch.models import audio as pa
    from vlut_tpu_torch.models import vocoder as pv
    from vlut_tpu_torch.runtime import tts
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    t_phase = time.time()
    cfg, model = built
    out: dict = {"phase": "audio", "model": "whisper_large_v3+ultravox -> "
                 "llama3_8b_158", "card": card}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acfg = pa.AudioConfig()
    t0 = time.time()
    ap = pa.init_params_fast(acfg, seed=27, device=dev)
    torch.cuda.synchronize()
    out["encoder_build_s"] = time.time() - t0
    out["encoder_params"] = az.n_params(ap)
    tok = Tokenizer(fixture)
    rng = np.random.default_rng(27)
    n = acfg.chunk_len_s * acfg.sample_rate - acfg.hop
    t = np.arange(n) / acfg.sample_rate
    samples = (0.3 * np.sin(2 * np.pi * 440.0 * t)
               + 0.05 * rng.standard_normal(n)).astype(np.float32)
    wav = ROOT / "build" / "phase27.wav"
    wav.parent.mkdir(exist_ok=True)
    tts.save_wav(str(wav), samples, acfg.sample_rate)
    t0 = time.perf_counter()
    mel_np = pa.log_mel(pa.load_wav(str(wav), acfg), acfg)
    out["log_mel_host_ms"] = (time.perf_counter() - t0) * 1e3
    wav.unlink()
    mel = torch.from_numpy(mel_np).to(dev)
    with torch.inference_mode():
        frames = pa.encode_tower(ap, acfg, mel)
        embeds = pa.project(ap, acfg, frames)
        out["tower_ms"] = cuda_ms(lambda: pa.encode_tower(ap, acfg, mel),
                                  iters=3, warmup=1)
        out["projector_ms"] = cuda_ms(lambda: pa.project(ap, acfg, frames),
                                      iters=5, warmup=1)
    out.update(mel_frames=int(mel.shape[0]), encoder_positions=int(
        frames.shape[0]), audio_rows=int(embeds.shape[0]))
    if (mel.shape[0] != 3000 or embeds.shape != (az.AUDIO_ROWS, cfg.d_model)
            or not torch.isfinite(embeds).all()):
        fail(f"audio encoder: mel {tuple(mel.shape)}, rows "
             f"{tuple(embeds.shape)}, finite "
             f"{bool(torch.isfinite(embeds).all())}")
    shim = types.SimpleNamespace(encode=tok.encode, eos_id=None)

    def timed(n_tok, mode="fused", graph=True):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = describe(model, cfg, shim, embeds, az.AUDIO_PROMPT, n_tok,
                        decode_attn=mode, cuda_graph=graph, marker="<audio>")
        torch.cuda.synchronize()
        return toks, (time.perf_counter() - t1) * 1e3

    timed(3)  # warm-up: each kernel shape's first launch, one capture
    _, out["prefill_ms"] = timed(1)
    reset()
    first, ms33 = timed(33)
    out["launches"] = {"fused": read("audio_describe_fused", (
        "ternary_gemm_tiled", "ternary_gemm_decode", "decode_attention"))}
    out["ms_per_token"] = (ms33 - out["prefill_ms"]) / 32
    second, _ = timed(33)
    # the marginal token of a longer run (96 more graph replays; the
    # prefill, the eager first step and the capture cancel)
    _, ms129 = timed(129)
    out["marginal_ms_per_token"] = (ms129 - ms33) / 96
    eager, ms33_eager = timed(33, graph=False)
    out["eager_ms_per_token"] = (ms33_eager - out["prefill_ms"]) / 32
    reset()
    composed, ms33_c = timed(33, "composed")
    out["composed_ms_per_token"] = (ms33_c - out["prefill_ms"]) / 32
    out["launches"]["composed"] = read("audio_describe_composed", (
        "ternary_gemm_tiled", "ternary_gemm_decode", "write_rows_pair"))
    composed_eager, _ = timed(33, "composed", graph=False)
    out.update(prefill_rows=az.prefill_rows(fixture)["describe"],
               tokens=first, runs_identical=first == second,
               graph_equals_eager=first == eager,
               composed_graph_equals_eager=composed == composed_eager)
    if len(first) != 33 or first != second:
        fail(f"describe --audio: two runs differ ({first} / {second})")
    if first != eager:
        fail(f"describe --audio: graphed decode {first} != eager {eager}")
    if composed != composed_eager:
        fail(f"describe --audio: graphed composed decode {composed} != "
             f"eager {composed_eager}")
    with torch.inference_mode():
        out["tower_profile"] = flagship.profile_decode(
            lambda: pa.encode_tower(ap, acfg, mel), 1, top=6)
    prefill_p = flagship.profile_decode(lambda: timed(1), 1, top=6)
    run17 = flagship.profile_decode(lambda: timed(17), 17, top=8)
    kern_ms = (17 * run17["kernel_ms_per_step"]
               - prefill_p["kernel_ms_per_step"]) / 16
    wall_ms = (17 * run17["wall_ms_per_step"]
               - prefill_p["wall_ms_per_step"]) / 16
    out["prefill_profile"] = prefill_p
    out["decode_profile"] = {
        "kernel_ms_per_token": kern_ms, "wall_ms_per_token": wall_ms,
        "idle_share": 1.0 - kern_ms / wall_ms, "run17": run17}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del ap, frames, embeds, mel
    torch.cuda.empty_cache()
    out["describe_s"] = time.time() - t_phase

    # (b) tts at full width
    t_tts = time.time()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tcfg, tmodel = flagship.build_model("outetts_0_2_500m", dev, seed=27)
    vcfg = pv.VocoderConfig()
    vp = pv.init_params_fast(vcfg, seed=27, device=dev)
    torch.cuda.synchronize()
    out["tts_build_s"] = time.time() - t0
    speaker = az.speaker_profile(27)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tts_tok = Tokenizer(az.outetts_tokenizer(fixture, d))
    ids, processed = tts.prompt_ids(tts_tok, az.TTS_TEXT, speaker)
    guide = tts.prepare_guide_tokens(tts_tok, processed)

    def codes(n_tok, graph=True, stats=None, decode_attn="fused"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = tts.generate_codes(tcfg, tmodel, tts_tok, ids,
                                  guide_tokens=guide,
                                  n_predict=n_tok, top_k=4, seed=27,
                                  cuda_graph=graph, stats=stats,
                                  decode_attn=decode_attn)
        torch.cuda.synchronize()
        return toks, (time.perf_counter() - t1) * 1e3

    codes(3)  # warm-up
    stats: dict = {}
    reset()
    stream, ms256 = codes(256, stats=stats)
    tts_launches = read("audio_tts", (
        "ternary_gemm_tiled", "ternary_gemm_fused_quant",
        "ternary_gemm_decode", "decode_attention"))
    # every step's attention is #7's (14 heads over 2, G 7): one launch a
    # layer, no composed attention (its row writer #5) anywhere in the run
    n_steps = len(stats["step_s"])
    if (tts_launches["decode_attention"] != tcfg.n_layers * n_steps
            or tts_launches["write_rows_pair"]):
        fail(f"tts: {n_steps} steps launched #7 "
             f"{tts_launches['decode_attention']} times (want "
             f"{tcfg.n_layers} a step) and #5 "
             f"{tts_launches['write_rows_pair']} times (want none)")
    again, _ = codes(256)
    # the eager steps (about 0.13 s each at this cache) for the stream's
    # first 32 tokens: a stream depends only on the tokens before it
    eager_stream, ms32_eager = codes(32, graph=False)
    # steps 3 onward are replays (1: eager, 2: the capture); the counted
    # run's step program replayed after its loop: its device time (CUDA
    # events over 20 replays) and one profile of 8 replays
    replays = stats["step_s"][2:]
    step = stats.pop("run")
    with torch.inference_mode():
        step_device_ms = cuda_ms(step, iters=20, warmup=2)
        step_prof = flagship.profile_decode(
            lambda: [step() for _ in range(8)], 8, top=10)
    # the same step composed (the row writer #5 and float32 attention
    # over the cache): 64 tokens graphed, timed and profiled as above
    del step
    cstats: dict = {}
    reset()
    composed_stream, _ = codes(64, stats=cstats, decode_attn="composed")
    composed_launches = read("audio_tts_composed", (
        "ternary_gemm_fused_quant", "ternary_gemm_decode", "write_rows_pair"))
    cstep = cstats.pop("run")
    with torch.inference_mode():
        c_device_ms = cuda_ms(cstep, iters=20, warmup=2)
        c_prof = flagship.profile_decode(
            lambda: [cstep() for _ in range(8)], 8, top=10)
    del cstep
    torch.cuda.empty_cache()
    # the fused step against the composed one at the prefill's end (the
    # first generated token at its position), layer by layer beside the
    # noise floor: the composed step with a relative 1e-6 of noise on
    # every layer's attention output
    paths = tts_attention_paths(tcfg, tmodel, ids, stream[0], dev)
    if not bench_engine.paths_ok(paths):
        fail(f"tts: a fused layer differs from the composed one by "
             f"{paths['max_rel_layer_diff']} of its largest value, past "
             f"{bench_engine.PATHS_X} x the noise floor "
             f"{paths['noise_floor']}")
    lo, hi = tts.detect_code_range(tts_tok)
    in_range = [c - lo for c in stream if lo <= c <= hi]
    out["tts"] = {
        "model": "outetts_0_2_500m", "vocoder": "VocoderConfig()",
        "vocoder_params": az.n_params(vp),
        "prompt_tokens": stats["prompt_tokens"], "n_predict": 256,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "step_ms_median": statistics.median(replays) * 1e3,
        "sample_host_ms_median": statistics.median(stats["sample_s"]) * 1e3,
        "sample_host_ms_total": sum(stats["sample_s"]) * 1e3,
        "run_ms": ms256, "eager_run32_ms": ms32_eager,
        "step_device_ms": step_device_ms, "step_profile": step_prof,
        "graph": stats["graph"],
        "launches": tts_launches, "tokens_head": stream[:24],
        "fused_vs_composed": {
            "step_ms_median": [statistics.median(replays) * 1e3,
                               statistics.median(cstats["step_s"][2:]) * 1e3],
            "step_device_ms": [step_device_ms, c_device_ms],
            "kernels_per_step": [step_prof["kernels_per_step"],
                                 c_prof["kernels_per_step"]],
            "launches_per_step": [
                {k: n / n_steps for k, n in tts_launches.items() if n},
                {k: n / len(cstats["step_s"])
                 for k, n in composed_launches.items() if n}],
            "composed_step_profile": c_prof,
            "composed_tokens_agree": sum(
                a == b for a, b in zip(stream, composed_stream)) / 64,
            "paths": paths, "bound_x_noise_floor": bench_engine.PATHS_X},
        "codes_in_range": len(in_range), "runs_identical": stream == again,
        "graph_equals_eager": stream[:32] == eager_stream,
    }
    if len(stream) != 256 or stream != again:
        fail("tts: two graphed runs give different streams")
    if stream[:32] != eager_stream:
        fail("tts: the graphed steps' stream differs from the eager one")
    seeded = np.random.default_rng(27).integers(0, vcfg.vocab_size, 750)
    with torch.inference_mode():
        embd = pv.decode_codes(vp, vcfg, seeded)
        out["tts"]["vocoder_ms"] = cuda_ms(
            lambda: pv.decode_codes(vp, vcfg, seeded), iters=3, warmup=1)
        out["tts"]["istft_ms"] = cuda_ms(
            lambda: pv.spectrogram_to_audio(embd, vcfg), iters=5, warmup=1)
    t0 = time.perf_counter()
    wave = tts.codes_to_audio(list(seeded), vcfg, vp)
    out["tts"]["codes_to_audio_ms"] = (time.perf_counter() - t0) * 1e3
    want_n = (750 - 1) * vcfg.hop + vcfg.n_fft - (vcfg.n_fft - vcfg.hop)
    out["tts"].update(audio_samples=int(wave.shape[0]),
                      audio_s=wave.shape[0] / vcfg.sample_rate,
                      audio_peak=float(np.abs(wave).max()))
    if wave.shape != (want_n,) or not np.isfinite(wave).all() or not (
            np.abs(wave[vcfg.sample_rate // 4:]).max() > 0):
        fail(f"codes_to_audio: {wave.shape} (want {want_n}), finite "
             f"{bool(np.isfinite(wave).all())}")
    out["tts"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del tmodel, vp, embd
    torch.cuda.empty_cache()
    out["tts_s"] = time.time() - t_tts

    # (c) the families card against CPU, and the CLI end to end
    t_fam = time.time()
    # TF32 allowed around the calls: the audio functions turn it off
    with tf32(matmul=True, conv=True):
        fams = az.card_vs_cpu(dev, seed=27)
    out["families"] = fams
    bad = [n for n, r in fams.items() if not r["ok"]]
    if bad:
        fail(f"audio families differ on the card: {bad} {fams}")
    out["cli"] = audio_cli_case(dev, fixture, reset, read)
    if not out["cli"]["ok"]:
        fail(f"audio CLI on the card differs from the CPU: {out['cli']}")
    out["families_s"] = time.time() - t_fam
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
