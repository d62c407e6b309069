"""Model configuration for the PyTorch port (own copy of vlut_tpu.config).

The port keeps its own copy so that it never imports the JAX package.  The
field set is identical, so every ``vlut_config.json`` the JAX converter
writes loads here unchanged; the model code raises ``NotImplementedError``
for the fields this port does not implement yet
(``models/transformer.check_supported``).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    arch: str = "llama"  # "llama" | "bitnet" (family label; behavior below)
    head_dim: int | None = None
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None  # llama3/yarn/linear/longrope
    tie_embeddings: bool = False
    use_subnorms: bool = False  # bitnet attn/ffn sub-norms (src/models/bitnet.cpp)
    weight_fmt: str = "i2"  # "i2" (2.0 bpw) | "i1" (1.6 bpw)
    max_seq_len: int = 4096
    # --- arch-superset switches (the reference's 103 per-arch graph builders
    # collapse into config-driven options; src/models/*.cpp) ---------------
    qkv_bias: bool = False        # qwen2-style q/k/v biases
    qk_norm: bool = False         # qwen3/gemma3 per-head RMSNorm on q and k
    act_fn: str = "silu"          # "silu" | "gelu" (gemma)
    embed_scale: float = 0.0      # gemma: sqrt(d_model); 0 = off
    post_norms: bool = False      # gemma2 post-attn/post-ffn RMSNorms
    norm_plus_one: bool = False   # gemma RMSNorm uses (1 + w)
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    logit_scale: float = 1.0      # granite: 1/logits_scaling;
    # minicpm: dim_model_base/hidden_size (residual/embedding multipliers
    # fold into weight scales at convert time — see convert.config_from_hf)
    attn_scale: float = 0.0       # custom 1/scale for QK^T; 0 = 1/sqrt(hd)
    sliding_window: int = 0       # SWA width; 0 = all-global attention
    sliding_window_pattern: int = 0  # every Nth layer is global (gemma2: 2)
    rope_theta_local: float = 0.0  # gemma3/mimo2/plamo3: SWA layers use a
    # different rope base (HF rope_local_base_freq, 10k) WITHOUT the global
    # table's rope_scaling; 0 = all layers share rope_theta (reference:
    # model.get_rope_freq_base(cparams, il) per-layer dispatch,
    # src/llama-model.cpp + src/models/gemma3*.cpp)
    # --- second arch-superset wave (gptneox/phi-2/starcoder2/cohere/
    # stablelm families; reference src/models/{gptneox,phi2,starcoder2,
    # command-r,stablelm}.cpp) ---------------------------------------------
    parallel_residual: bool = False  # x + attn(h) + ffn(h'): gptneox (two
    # norms), phi-2/cohere (single norm — ffn reuses the attn-normed input)
    rope_pct: float = 1.0         # partial rotary: rope on the first
    # rope_pct*head_dim dims only (gptneox rotary_pct, phi-2/stablelm
    # partial_rotary_factor)
    ffn_gated: bool = True        # False: classic up -> act -> down MLP
    rope_interleaved: bool = False  # original-GPT-style pairwise rope
    # (cohere/GLM; reference ROPE_TYPE_NORM vs NEOX).  Implemented as an
    # even|odd channel permutation of q/k before half-split rope — the
    # inverse permutation cancels inside the q.k dot, so attention and
    # the KV cache stay layout-consistent.
    norm_type: str = "rms"        # "rms" | "ln" (LayerNorm, mean-centered,
    # optional per-norm bias tensors "<name>_b")
    proj_bias: bool = False       # biases on wo and the FFN projections
    # (gptneox/phi-2/starcoder2 put biases on every linear)
    # --- third arch-superset wave (gpt2/bloom/mpt/falcon/olmo/olmo2/
    # nemotron/glm4/cohere2/smollm3/opt; reference src/models/{gpt2,bloom,
    # mpt,falcon,olmo,olmo2,nemotron,glm4,cohere2,smollm,...}.cpp) --------
    pos_embed: str = "rope"       # "rope" | "learned" (gpt2/opt absolute
    # position table) | "alibi" (bloom/mpt per-head linear score bias) |
    # "none" (pure NoPE)
    embed_norm: bool = False      # bloom word_embeddings_layernorm after
    # the embedding lookup (params: embed_norm / embed_norm_b)
    pre_norms: bool = True        # False: olmo2 norm-after-block ordering —
    # no pre-norms; post_norms are applied to each branch OUTPUT before
    # the residual add (combine with post_norms=True)
    qk_norm_scope: str = "head"   # "head" (qwen3/gemma3 per-head) |
    # "whole" (olmo2: one RMSNorm over the flattened n_heads*head_dim q/k)
    qk_norm_post_rope: bool = False  # hunyuan-v1: per-head q/k RMSNorm is
    # applied AFTER rope (qwen3/gemma3 norm before rope)
    qk_norm_type: str = "rms"     # "ln": chameleon per-head LayerNorm with
    # (H, head_dim) weight+bias and fixed eps 1e-5 (ChameleonLayerNorm);
    # "l2": llama4 weightless per-head L2 norm (Llama4TextL2Norm), applied
    # AFTER rope and ONLY on rope layers (combine with qk_norm_post_rope)
    qkv_clamp: float = 0.0        # dbrx/olmo clip_qkv: clamp q/k/v to
    # [-c, +c] after the projection (before rope)
    swa_layers: tuple[bool, ...] | None = None  # explicit per-layer SWA
    # flags (HF layer_types) overriding sliding_window_pattern
    swa_type: str = "window"      # "window" (rolling kp > qp - w) |
    # "chunked" (llama4: kp and qp must share floor(pos/w) — reference
    # LLAMA_SWA_TYPE_CHUNKED, src/llama-hparams.h)
    attn_temp_scale: float = 0.0  # llama4 NoPE-layer attention temperature
    # tuning: q *= log(floor((pos+offset)/floor_scale)+1)*scale + 1
    # (reference llm_graph_input_attn_temp, src/llama-graph.cpp:81)
    attn_temp_floor: int = 8192
    attn_temp_offset: float = 1.0
    moe_weight_before: bool = False  # llama4: router weights scale the
    # expert INPUT instead of the output (build_moe_ffn weight_before_ffn)
    moe_chunk_experts: int = 0    # grovemoe adjugate "chunk" experts: a
    # second, smaller expert bank (n_experts / experts_per_group) applied
    # to the ROUTED OUTPUT, reusing the same router logits with expert id
    # -> id // group; output added scaled by moe_chunk_scale (reference
    # src/models/grovemoe.cpp + build_moe_ffn GROVEMOE branches)
    moe_chunk_scale: float = 0.05
    d_ff_chunk: int = 0           # chunk-expert FFN width
    moe_parallel: str = ""        # "arctic": the routed MoE branch reads a
    # SEPARATE norm of the layer input (ffn_norm_exps) and adds after the
    # residual_mlp dense branch: out = moe(norm2(x_in)) + (ffn_inp +
    # dense(norm(ffn_inp))) — reference src/models/arctic.cpp
    nope_layers: tuple[bool, ...] | None = None  # per-layer "skip rope"
    # (cohere2 global layers, smollm3 no_rope_layers)
    dual_expert: bool = False     # cogvlm: every layer carries a second
    # (visual-expert) weight set vis_*; forward(visual_expert=True)
    # selects it for image-embedding batches (src/models/cogvlm.cpp)
    attn_gate: str = ""           # "sigmoid": afmoe attention output gate —
    # gate = w_attn_gate @ attn_norm(x), attention output (pre-o_proj)
    # multiplied by sigmoid(gate) (reference src/models/afmoe.cpp)
    moe_router_input: str = "hidden"  # "layer_input": smallthinker computes
    # the router logits on the RAW layer input (before any norm), while the
    # experts still read the ffn-normed hidden (src/models/smallthinker.cpp)
    heads_per_layer: tuple[tuple[int, int], ...] | None = None  # per-layer
    # (n_heads, n_kv_heads) — openelm/deci/mimo2/plamo3 heterogeneous
    # attention.  Forces the tuple-layers (unrolled) checkpoint layout;
    # layer_step derives each layer's counts from its projection widths.
    # n_heads/n_kv_heads hold the per-layer MAXIMA (sizing KV caches)
    d_ff_per_layer: tuple[int, ...] | None = None  # per-layer FFN width
    # (openelm ffn_multipliers, deci per-block n_ff; 0 = FFN-free layer)
    alibi_scaled: bool = False    # falcon folds 1/sqrt(head_dim) into the
    # alibi bias ((scores + alibi) * inv_norm); bloom/mpt add it unscaled
    attn_sinks: bool = False      # gpt-oss learned per-head sink logits
    # (params: lp["sinks"]) folded into the softmax denominator
    swiglu_limit: float = 0.0     # gpt-oss clamped swiglu: gate clamped to
    # (-inf, limit], up to [-limit, limit], act = gate*sigmoid(1.702*gate)
    moe_expert_bias: bool = False  # gpt-oss per-expert projection biases
    # (b_gate/b_up/b_down stacked over experts)
    # --- MLA latent-KV attention (deepseek V2/V3; reference
    # src/models/deepseek2.cpp).  Active when kv_lora_rank > 0: the cache
    # holds ONE (kv_lora_rank + qk_rope_dim)-wide latent row per position
    # and attention runs absorbed (q_nope @ W_uk against the latent) ------
    q_lora_rank: int = 0          # 0 = direct q projection (V2-Lite)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0          # rope width (shared single k_pe head)
    # --- mixture of experts (mixtral/qwen-moe family; reference
    # build_moe_ffn, src/llama-graph.cpp:1045) -----------------------------
    n_experts: int = 0
    n_experts_used: int = 0
    moe_norm_topk: bool = True    # renormalize the top-k router weights
    # deepseek-MoE extensions (reference: llm_build_deepseek2 +
    # build_moe_ffn gating args, src/llama-graph.cpp):
    moe_score: str = "softmax"    # "softmax" (V2) | "sigmoid" (V3)
    n_expert_groups: int = 0      # V3 grouped routing (n_group)
    topk_groups: int = 0          # groups kept before the expert top-k
    routed_scale: float = 1.0     # routed_scaling_factor on the combine
    n_shared_experts: int = 0     # always-on shared-expert FFN width mult
    first_k_dense: int = 0        # layers [0, k) use a dense FFN instead
    d_ff_dense: int = 0           # width of those dense FFNs
    d_ff_shared: int = 0          # explicit shared-expert width (qwen2-moe
    # shared_expert_intermediate_size) overriding n_shared * d_ff
    dense_layers: tuple[bool, ...] | None = None  # arbitrary per-layer
    # dense-FFN flags (qwen2/qwen3-moe mlp_only_layers +
    # decoder_sparse_step); like first_k_dense but any layer set —
    # forces the heterogeneous tuple-layers checkpoint layout
    # --- diffusion LMs (llada/dream/rnd1; reference examples/diffusion +
    # src/models/{llada,dream,rnd1}.cpp): bidirectional attention +
    # iterative mask denoising (runtime/diffusion.py) ---------------------
    causal_attn: bool = True      # False: diffusion archs (GGUF
    # add_causal_attention(False))
    mask_token_id: int = 0        # the [MASK] the denoiser fills
    diffusion_shift_logits: bool = True  # dream/rnd1 predict position i+1
    # from logits[i]; llada predicts position i in place (GGUF
    # add_diffusion_shift_logits(False))
    # checkpoints are packed with enough padding to shard evenly over any
    # tensor-parallel degree dividing tp_pack (see models/dims.py)
    tp_pack: int = 8

    def swa_flags(self) -> tuple[bool, ...]:
        """Per-layer sliding-window flags: explicit HF layer_types when
        present, else the gemma2-style pattern (every Nth layer global).
        Shared by forward() masking and the engine's context-shift rope
        rebase (which must pick the local-theta table for SWA layers)."""
        if not self.sliding_window:
            return tuple(False for _ in range(self.n_layers))
        if self.swa_layers is not None:
            return tuple(bool(f) for f in self.swa_layers)
        pat = self.sliding_window_pattern
        if not pat:
            return tuple(True for _ in range(self.n_layers))
        return tuple(i % pat != pat - 1 for i in range(self.n_layers))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_


# --- presets (hparams per public HF configs of the paper's model zoo) -------

PRESETS: dict[str, ModelConfig] = {
    # 1bitLLM/bitnet_b1_58-3B — BITNET arch w/ sub-norms
    "bitnet_3b": ModelConfig(
        arch="bitnet", vocab_size=32002, d_model=3200, n_layers=26,
        n_heads=32, n_kv_heads=32, d_ff=8640, rms_eps=1e-5,
        rope_theta=10000.0, use_subnorms=True,
    ),
    # HF1BitLLM/Llama3-8B-1.58-100B-tokens — LLAMA arch
    "llama3_8b_158": ModelConfig(
        arch="llama", vocab_size=128256, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, rms_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling=None,
    ),
    # same model in the 1.6-bpw i1 format (the reference's I1_V_2 demo
    # type, evaluation/demo/run_batched_decode.sh)
    "llama3_8b_158_i1": ModelConfig(
        arch="llama", vocab_size=128256, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, rms_eps=1e-5,
        rope_theta=500000.0, weight_fmt="i1",
    ),
    # tiiuae/Falcon3-1B-Instruct-1.58bit — LlamaForCausalLM
    "falcon3_1b_158": ModelConfig(
        arch="llama", vocab_size=131072, d_model=2048, n_layers=18,
        n_heads=8, n_kv_heads=4, d_ff=8192, head_dim=256,
        rms_eps=1e-6, rope_theta=1000042.0, weight_fmt="i1",
    ),
    # SpectraSuite/TriLM_3.9B — LLAMA arch
    "trilm_3_9b": ModelConfig(
        arch="llama", vocab_size=50688, d_model=3072, n_layers=30,
        n_heads=24, n_kv_heads=24, d_ff=9216, rms_eps=1e-5,
        rope_theta=10000.0, weight_fmt="i1",
    ),
    # microsoft/bitnet-b1.58-2B-4T — the current flagship open ternary model
    "bitnet_2b_4t": ModelConfig(
        arch="bitnet", vocab_size=128256, d_model=2560, n_layers=30,
        n_heads=20, n_kv_heads=5, d_ff=6912, rms_eps=1e-5,
        rope_theta=500000.0, use_subnorms=True,
    ),
    # Qwen/Qwen3-4B shapes (qk-norm family; for synthetic benches)
    "qwen3_4b": ModelConfig(
        arch="llama", vocab_size=151936, d_model=2560, n_layers=36,
        n_heads=32, n_kv_heads=8, d_ff=9728, head_dim=128,
        rms_eps=1e-6, rope_theta=1000000.0, qk_norm=True,
    ),
    # google/gemma-2-2b shapes (sandwich norms + softcaps + SWA)
    "gemma2_2b": ModelConfig(
        arch="llama", vocab_size=256000, d_model=2304, n_layers=26,
        n_heads=8, n_kv_heads=4, d_ff=9216, head_dim=256,
        rms_eps=1e-6, rope_theta=10000.0, act_fn="gelu",
        embed_scale=2304 ** 0.5, norm_plus_one=True, post_norms=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        sliding_window=4096, sliding_window_pattern=2,
        attn_scale=256 ** -0.5, tie_embeddings=True,
    ),
    # mistralai/Mixtral-8x7B-v0.1 widths (its config.json): 8 experts of
    # 14336 with top-2 softmax routing, 32/8 heads of 128, no sliding
    # window, untied head; what the JAX converter's config_from_hf makes of
    # it (tests/test_torch_moe.py holds the two equal).  Port-only: the
    # full-width MoE model of the port's card runs (chip_smoke.py phase 20)
    "mixtral_8x7b": ModelConfig(
        arch="llama", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, head_dim=128, rms_eps=1e-5,
        rope_theta=1e6, max_seq_len=32768, n_experts=8, n_experts_used=2,
    ),
    # deepseek-ai/DeepSeek-V2-Lite widths (its config.json): MLA attention
    # (16 heads, no q-LoRA, a latent of 512, nope 128, rope 64, v 128, yarn
    # factor 40), 64 routed experts of 1408, top 6 softmax without
    # renormalisation, 2 shared experts, one dense lead layer of 10944,
    # vocabulary 102400, untied head; what the JAX converter's
    # config_from_hf makes of it (its max_seq_len capped at 131072; tests/
    # test_torch_archs_mla.py holds the two equal).  Port-only: the
    # full-width MLA model of the port's card runs (chip_smoke.py phase 21)
    "deepseek_v2_lite": ModelConfig(
        arch="llama", vocab_size=102400, d_model=2048, n_layers=27,
        n_heads=16, n_kv_heads=16, d_ff=1408, head_dim=128, rms_eps=1e-6,
        rope_theta=10000.0, rope_scaling={
            "beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
            "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
            "type": "yarn"},
        max_seq_len=131072, attn_scale=(128 + 64) ** -0.5,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        n_experts=64, n_experts_used=6, moe_norm_topk=False,
        n_expert_groups=1, topk_groups=1, n_shared_experts=2,
        first_k_dense=1, d_ff_dense=10944,
    ),
    # GSAI-ML/LLaDA-8B-Instruct widths (its config.json): a masked-diffusion
    # LM, bidirectional attention, 32 heads over 32 KV heads of 128,
    # mlp_hidden_size 12288, vocabulary 126464, [MASK] 126336, in-place
    # logits (no shift), untied head; what the JAX converter's
    # config_from_hf makes of it (tests/test_torch_diffusion.py holds the
    # two equal).  Port-only: the full-width diffusion model of the port's
    # card runs (chip_smoke.py phase 23)
    "llada_8b": ModelConfig(
        arch="llama", vocab_size=126464, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, d_ff=12288, rms_eps=1e-5,
        rope_theta=500000.0, max_seq_len=4096, causal_attn=False,
        mask_token_id=126336, diffusion_shift_logits=False,
    ),
    # llava-hf/llava-1.5-7b-hf's text side (its config.json's text_config:
    # Llama-2-7B's widths, d 4096, 32 layers, 32 heads over 32 KV heads of
    # 128, d_ff 11008, vocabulary 32064, rms eps 1e-5, 4096 positions);
    # what the JAX converter's config_from_hf makes of it
    # (tests/test_torch_vision_zoo.py holds the two equal).  Port-only: the
    # full-width multimodal model of the port's card runs (chip_smoke.py
    # phase 26; its tower is models/vision.py's VisionConfig defaults,
    # CLIP ViT-L/14-336)
    "llava_1_5_7b": ModelConfig(
        arch="llama", vocab_size=32064, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, d_ff=11008, rms_eps=1e-5,
        rope_theta=10000.0, max_seq_len=4096,
    ),
    # OuteTTS-0.2-500M's text-to-codes model on Qwen2.5-0.5B's architecture
    # (d 896, 24 layers, 14 query heads over 2 KV heads of 64, d_ff 4864,
    # q/k/v biases, rms eps 1e-6, rope theta 1,000,000, 32,768 positions,
    # the embedding tied as the head) with OuteTTS-0.2's vocabulary of
    # 157,696, which holds the <|N|> audio-code tokens; what the JAX
    # converter's config_from_hf makes of such a Qwen2 config.json
    # (tests/test_torch_tts.py holds the two equal).  Port-only: the
    # full-width text-to-speech model of the port's card runs
    # (chip_smoke.py phase 27; its vocoder is models/vocoder.py's
    # VocoderConfig defaults, WavTokenizer)
    "outetts_0_2_500m": ModelConfig(
        arch="llama", vocab_size=157696, d_model=896, n_layers=24,
        n_heads=14, n_kv_heads=2, d_ff=4864, rms_eps=1e-6,
        rope_theta=1000000.0, max_seq_len=32768, qkv_bias=True,
        tie_embeddings=True,
    ),
    # tiny configs for tests
    "tiny": ModelConfig(
        arch="llama", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128,
        rope_theta=10000.0,
    ),
    "tiny_bitnet": ModelConfig(
        arch="bitnet", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=256, max_seq_len=128,
        use_subnorms=True,
    ),
    # qwen3-style: qk-norm, no bias
    "tiny_qwen3": ModelConfig(
        arch="llama", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128,
        qk_norm=True, rms_eps=1e-6,
    ),
    # qwen2-style: qkv biases
    "tiny_qwen2": ModelConfig(
        arch="llama", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128,
        qkv_bias=True,
    ),
    # gemma2-style: gelu, embed scale, post-norms, softcaps, (1+w) norm,
    # alternating sliding-window attention
    "tiny_gemma2": ModelConfig(
        arch="llama", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128,
        act_fn="gelu", embed_scale=128 ** 0.5, post_norms=True,
        norm_plus_one=True, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, sliding_window=16,
        sliding_window_pattern=2, tie_embeddings=True,
    ),
    # mixtral-style MoE: 4 experts, top-2
    "tiny_moe": ModelConfig(
        arch="llama", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128,
        n_experts=4, n_experts_used=2,
    ),
    # granite-style: embedding/attention multipliers + logits_scaling
    # (residual_multiplier folds into weights at convert time)
    "tiny_granite": ModelConfig(
        arch="llama", vocab_size=256, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128,
        embed_scale=12.0, attn_scale=0.0078125, logit_scale=1 / 16.0,
        tie_embeddings=True,
    ),
    # deepseek-style MLA (latent-KV) shapes, scaled down but lane-aligned:
    # q_lora 256, kv_lora 256, nope 128, rope 64, v 128
    "tiny_mla": ModelConfig(
        arch="llama", vocab_size=256, d_model=256, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=256, head_dim=128, max_seq_len=128,
        q_lora_rank=256, kv_lora_rank=256, qk_nope_dim=128, qk_rope_dim=64,
        attn_scale=(128 + 64) ** -0.5,
    ),
}
