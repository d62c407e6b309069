"""Vision-tower converters: HF tower tensors -> the sidecar files beside a
checkpoint's ``model.safetensors`` (own copy of the JAX package's
``vlut_tpu/convert/convert.py`` ``_convert_*`` vision functions, with
their names).

Each takes the raw tower tensors (``vision_raw``: names without the
``model.`` prefix), the HF ``config.json`` as a dict and the output
directory; writes its sidecar (float32 arrays, weights transposed to
(in, out) and stacked over layers as ``layers.<name>``) and returns the
tower's config dict, which :func:`convert.convert_hf` records in the meta
under the key the sidecar's loader reads (``convert/checkpoint.py``).
Tower weights are float and never packed; every operation here is host
numpy, so either device writes the same files.
"""

from __future__ import annotations

import logging
import pathlib
import re
from typing import Any

import numpy as np

from vlut_tpu_torch.convert.checkpoint import write_safetensors

log = logging.getLogger("vlut_tpu_torch.convert")


def convert_towers(vision_raw: dict[str, np.ndarray],
                   qwen_vis_raw: dict[str, np.ndarray],
                   cfgd: dict[str, Any], out_dir) -> dict[str, Any]:
    """Write the sidecars of a checkpoint's tower tensors; returns the meta
    entries (each tower's config and its token ids), the JAX converter's
    dispatch."""
    out_dir = pathlib.Path(out_dir)
    meta: dict[str, Any] = {}
    if vision_raw:
        vmt = (cfgd.get("vision_config") or {}).get("model_type", "")
        if vmt in TOWERS:
            key, fn = TOWERS[vmt]
            meta[key] = fn(vision_raw, cfgd, out_dir)
            meta["image_token_id"] = cfgd.get(
                "image_token_index", cfgd.get("image_token_id"))
        else:
            meta["vision_config"] = _convert_vision_tower(vision_raw, cfgd,
                                                          out_dir)
    if qwen_vis_raw:
        meta["qwen_vision_config"] = _convert_qwen_vision(qwen_vis_raw, cfgd,
                                                          out_dir)
        meta["image_token_id"] = cfgd.get("image_token_id")
        meta["vision_start_token_id"] = cfgd.get("vision_start_token_id")
    return meta


def _write(out: dict[str, np.ndarray], path: pathlib.Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    write_safetensors(path, {k: np.ascontiguousarray(v, np.float32)
                             for k, v in out.items()})


def _stacks(raw: dict[str, np.ndarray], pattern: str, name_map: dict,
            n_layers: int, warn: str | None = None,
            drop_missing: bool = False) -> dict[str, np.ndarray]:
    """The per-layer tensors matching ``pattern`` (groups: layer, sub-name)
    stacked as ``layers.<ours>``.  ``name_map``: sub-name -> ours, or ->
    (ours, transposed); a bare name is transposed when it starts with "w".
    A name no layer has is left out; ``drop_missing`` stacks the layers
    present (the CLIP tower), else a partial stack raises.  ``warn``: log
    the sub-names ``name_map`` lacks."""
    lre = re.compile(pattern)
    spec = {k: (v if isinstance(v, tuple) else (v, v.startswith("w")))
            for k, v in name_map.items()}
    stacks: dict[str, list] = {nm: [None] * n_layers
                               for nm, _ in spec.values()}
    for name, w in raw.items():
        m = lre.match(name)
        if not m:
            continue
        li, sub = int(m.group(1)), m.group(2)
        if sub not in spec:
            if warn:
                log.warning(warn, name)
            continue
        nm, tr = spec[sub]
        arr = np.asarray(w, np.float32)
        stacks[nm][li] = arr.T if tr else arr
    out = {}
    for nm, vals in stacks.items():
        have = [v for v in vals if v is not None]
        if not have:
            continue
        if len(have) != len(vals) and not drop_missing:
            raise ValueError(f"{nm}: missing layers in the tower")
        out[f"layers.{nm}"] = np.stack(have)
    return out


def _conv(pw: np.ndarray) -> np.ndarray:
    """(d, C, p, p) conv weight -> (p*p*C, d), patchify's (ph, pw, C)."""
    return pw.transpose(2, 3, 1, 0).reshape(-1, pw.shape[0])


def _first(v, default):
    """A size given as [h, w] or as one int."""
    return v[0] if isinstance(v, list) else (default if v is None else v)


_SIGLIP_BLOCK = {
    "layer_norm1.weight": "ln1_w", "layer_norm1.bias": "ln1_b",
    "layer_norm2.weight": "ln2_w", "layer_norm2.bias": "ln2_b",
    "self_attn.q_proj.weight": "wq", "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.weight": "wk", "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.weight": "wv", "self_attn.v_proj.bias": "bv",
    "self_attn.out_proj.weight": "wo", "self_attn.out_proj.bias": "bo",
    "mlp.fc1.weight": "w1", "mlp.fc1.bias": "b1",
    "mlp.fc2.weight": "w2", "mlp.fc2.bias": "b2",
}


def _siglip_block_stack(raw, prefix: str, n_layers: int,
                        out_proj: str = "out_proj") -> dict[str, np.ndarray]:
    """The siglip-shaped encoder blocks of siglip, siglip2, idefics3 and
    janus towers."""
    nmap = {k.replace("out_proj", out_proj): v
            for k, v in _SIGLIP_BLOCK.items()}
    return _stacks(raw, rf"{re.escape(prefix)}encoder\.layers\.(\d+)\.(.+)$",
                   nmap, n_layers)


def _convert_qwen_vision(raw, cfgd, out_dir: pathlib.Path) -> dict[str, Any]:
    """Qwen2-VL / 2.5-VL tower -> qwen_vision.safetensors."""
    v = cfgd.get("vision_config", {})
    embed = v.get("embed_dim", v.get("hidden_size", 1280))
    depth = v.get("depth", 32)
    is_25 = "fullatt_block_indexes" in v or v.get("window_size")
    qvcfg: dict[str, Any] = {
        "depth": depth,
        "embed_dim": embed,
        "n_heads": v.get("num_heads", 16),
        "mlp_dim": v.get("intermediate_size") if is_25
        else int(embed * v.get("mlp_ratio", 4)),
        "patch_size": v.get("patch_size", 14),
        "temporal_patch_size": v.get("temporal_patch_size", 2),
        "spatial_merge_size": v.get("spatial_merge_size", 2),
        "in_channels": v.get("in_channels", 3),
        "out_dim": v.get("out_hidden_size", v.get("hidden_size", embed)),
    }
    if is_25:
        qvcfg.update(rms_norm=True, gated_mlp=True,
                     window_size=v.get("window_size", 112),
                     fullatt_blocks=tuple(v.get("fullatt_block_indexes", ())))
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    pw = g("patch_embed.proj.weight")  # (D, C, tp, p, p)
    out = {
        "patch_w": pw.reshape(pw.shape[0], -1).T,
        "merge_ln_w": g("merger.ln_q.weight"),
        "merge_w1": g("merger.mlp.0.weight").T,
        "merge_b1": g("merger.mlp.0.bias"),
        "merge_w2": g("merger.mlp.2.weight").T,
        "merge_b2": g("merger.mlp.2.bias"),
    }
    if "merger.ln_q.bias" in raw:
        out["merge_ln_b"] = g("merger.ln_q.bias")
    name_map = {
        "norm1.weight": "ln1_w", "norm1.bias": "ln1_b",
        "norm2.weight": "ln2_w", "norm2.bias": "ln2_b",
        "attn.qkv.weight": "wqkv", "attn.qkv.bias": "bqkv",
        "attn.proj.weight": "wo", "attn.proj.bias": "bo",
        "mlp.fc1.weight": "w1", "mlp.fc1.bias": "b1",
        "mlp.fc2.weight": "w2", "mlp.fc2.bias": "b2",
        # qwen2.5's gated MLP (with biases)
        "mlp.gate_proj.weight": "w_gate", "mlp.gate_proj.bias": "b_gate",
        "mlp.up_proj.weight": "w1", "mlp.up_proj.bias": "b1",
        "mlp.down_proj.weight": "w2", "mlp.down_proj.bias": "b2",
    }
    out.update(_stacks(raw, r"blocks\.(\d+)\.(.+)$", name_map, depth,
                       warn="skipping qwen vision tensor %s"))
    _write(out, out_dir / "qwen_vision.safetensors")
    return qvcfg


def _convert_siglip_gemma3(raw, cfgd, out_dir: pathlib.Path):
    """Gemma3's SigLIP tower + avg-pool projector -> siglip.safetensors."""
    v = cfgd.get("vision_config", {})
    scfg = {
        "image_size": v.get("image_size", 896),
        "patch_size": v.get("patch_size", 14),
        "d_model": v.get("hidden_size", 1152),
        "n_layers": v.get("num_hidden_layers", 27),
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": v.get("intermediate_size", 4304),
        "ln_eps": v.get("layer_norm_eps", 1e-6),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 2560),
        "mm_tokens_per_image": cfgd.get("mm_tokens_per_image", 256),
    }
    p = "vision_tower.vision_model."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": _conv(g(f"{p}embeddings.patch_embedding.weight")),
        "patch_b": g(f"{p}embeddings.patch_embedding.bias"),
        "pos": g(f"{p}embeddings.position_embedding.weight"),
        "post_ln_w": g(f"{p}post_layernorm.weight"),
        "post_ln_b": g(f"{p}post_layernorm.bias"),
        "soft_emb_norm": g("multi_modal_projector.mm_soft_emb_norm.weight"),
        "mm_proj": g("multi_modal_projector.mm_input_projection_weight"),
    }
    out.update(_siglip_block_stack(raw, p, scfg["n_layers"]))
    _write(out, out_dir / "siglip.safetensors")
    return scfg


def _convert_internvl_vision(raw, cfgd, out_dir: pathlib.Path):
    """InternVL's CLS-token ViT + LN / GELU projector ->
    internvl.safetensors."""
    v = cfgd.get("vision_config", {})
    ratio = cfgd.get("downsample_ratio", 0.5)
    icfg = {
        "image_size": _first(v.get("image_size"), 448),
        "patch_size": _first(v.get("patch_size"), 14),
        "d_model": v.get("hidden_size", 1024),
        "n_layers": v.get("num_hidden_layers", 24),
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": v.get("intermediate_size", 4096),
        "ln_eps": v.get("layer_norm_eps", 1e-6),
        "norm_type": v.get("norm_type", "layer_norm"),
        "use_qk_norm": v.get("use_qk_norm", False),
        "downsample": int(round(1.0 / ratio)),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 4096),
        "proj_act": cfgd.get("projector_hidden_act", "gelu"),
    }
    p = "vision_tower."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": _conv(g(f"{p}embeddings.patch_embeddings.projection"
                           ".weight")),
        "patch_b": g(f"{p}embeddings.patch_embeddings.projection.bias"),
        "cls": g(f"{p}embeddings.cls_token").reshape(-1),
        "proj_ln_w": g("multi_modal_projector.layer_norm.weight"),
        "proj_ln_b": g("multi_modal_projector.layer_norm.bias"),
        "proj_w1": g("multi_modal_projector.linear_1.weight").T,
        "proj_b1": g("multi_modal_projector.linear_1.bias"),
        "proj_w2": g("multi_modal_projector.linear_2.weight").T,
        "proj_b2": g("multi_modal_projector.linear_2.bias"),
    }
    if f"{p}embeddings.position_embeddings" in raw:
        out["pos"] = g(f"{p}embeddings.position_embeddings")[0]
    if f"{p}layernorm.weight" in raw:  # use_mean_pooling=False variants
        out["final_ln_w"] = g(f"{p}layernorm.weight")
        if f"{p}layernorm.bias" in raw:
            out["final_ln_b"] = g(f"{p}layernorm.bias")
    name_map = {
        "layernorm_before.weight": "ln1_w", "layernorm_before.bias": "ln1_b",
        "layernorm_after.weight": "ln2_w", "layernorm_after.bias": "ln2_b",
        "attention.q_proj.weight": "wq", "attention.q_proj.bias": "bq",
        "attention.k_proj.weight": "wk", "attention.k_proj.bias": "bk",
        "attention.v_proj.weight": "wv", "attention.v_proj.bias": "bv",
        "attention.projection_layer.weight": "wo",
        "attention.projection_layer.bias": "bo",
        "attention.q_norm.weight": "qn", "attention.k_norm.weight": "kn",
        "lambda_1": "ls1", "lambda_2": "ls2",
        "mlp.fc1.weight": "w1", "mlp.fc1.bias": "b1",
        "mlp.fc2.weight": "w2", "mlp.fc2.bias": "b2",
    }
    drop = set()
    if icfg["norm_type"] == "rms_norm":
        drop |= {"ln1_b", "ln2_b"}     # RMS norms have no bias tensors
    if not icfg["use_qk_norm"]:
        drop |= {"qn", "kn"}
    name_map = {k: v_ for k, v_ in name_map.items() if v_ not in drop}
    out.update(_stacks(raw, rf"{re.escape(p)}encoder\.layer\.(\d+)\.(.+)$",
                       name_map, icfg["n_layers"]))
    _write(out, out_dir / "internvl.safetensors")
    return icfg


def _convert_llama4_vision(raw, cfgd, out_dir: pathlib.Path):
    """Llama4's tower + pixel-shuffle adapter + projector ->
    llama4_vision.safetensors."""
    v = cfgd.get("vision_config", {})
    lcfg = {
        "image_size": v.get("image_size", 336),
        "patch_size": v.get("patch_size", 14),
        "d_model": v.get("hidden_size", 1408),
        "n_layers": v.get("num_hidden_layers", 34),
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": v.get("intermediate_size", 5632),
        "rope_theta": v.get("rope_theta", 10000.0),
        "ln_eps": v.get("norm_eps", 1e-5),
        "pixel_shuffle_ratio": v.get("pixel_shuffle_ratio", 0.5),
        "projector_input_dim": v.get("projector_input_dim", 4096),
        "projector_output_dim": v.get("projector_output_dim", 4096),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 5120),
    }
    p = "vision_model."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    ps, d = lcfg["patch_size"], lcfg["d_model"]
    # Unfold flattens each patch channel-major (C, ph, pw)
    uw = g(f"{p}patch_embedding.linear.weight").reshape(d, 3, ps, ps)
    out = {
        "patch_w": _conv(uw),
        "cls": g(f"{p}class_embedding"),
        "pos": g(f"{p}positional_embedding_vlm"),
        "pre_ln_w": g(f"{p}layernorm_pre.weight"),
        "pre_ln_b": g(f"{p}layernorm_pre.bias"),
        "post_ln_w": g(f"{p}layernorm_post.weight"),
        "post_ln_b": g(f"{p}layernorm_post.bias"),
        "adapter_w1": g(f"{p}vision_adapter.mlp.fc1.weight").T,
        "adapter_w2": g(f"{p}vision_adapter.mlp.fc2.weight").T,
        "mm_proj": g("multi_modal_projector.linear_1.weight").T,
    }
    name_map = {
        "input_layernorm.weight": "ln1_w", "input_layernorm.bias": "ln1_b",
        "post_attention_layernorm.weight": "ln2_w",
        "post_attention_layernorm.bias": "ln2_b",
        "self_attn.q_proj.weight": "wq", "self_attn.q_proj.bias": "bq",
        "self_attn.k_proj.weight": "wk", "self_attn.k_proj.bias": "bk",
        "self_attn.v_proj.weight": "wv", "self_attn.v_proj.bias": "bv",
        "self_attn.o_proj.weight": "wo", "self_attn.o_proj.bias": "bo",
        "mlp.fc1.weight": "w1", "mlp.fc1.bias": "b1",
        "mlp.fc2.weight": "w2", "mlp.fc2.bias": "b2",
    }
    out.update(_stacks(raw, rf"{re.escape(p)}model\.layers\.(\d+)\.(.+)$",
                       name_map, lcfg["n_layers"]))
    _write(out, out_dir / "llama4_vision.safetensors")
    return lcfg


def _convert_janus_vision(raw, cfgd, out_dir: pathlib.Path):
    """Janus-Pro's understanding tower + aligner -> janus.safetensors (the
    image-generation path is dropped)."""
    v = cfgd.get("vision_config", {})
    jcfg = {
        "image_size": v.get("image_size", 384),
        "patch_size": v.get("patch_size", 16),
        "d_model": v.get("hidden_size", 1024),
        "n_layers": v.get("num_hidden_layers", 24),
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": int(v.get("hidden_size", 1024) * v.get("mlp_ratio", 4.0)),
        "ln_eps": v.get("layer_norm_eps", 1e-6),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 2048),
        "mm_tokens_per_image": 0,
    }
    p = "vision_model."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": _conv(g(f"{p}embeddings.patch_embedding.weight")),
        "patch_b": g(f"{p}embeddings.patch_embedding.bias"),
        "pos": g(f"{p}embeddings.position_embedding.weight"),
        "post_ln_w": g(f"{p}post_layernorm.weight"),
        "post_ln_b": g(f"{p}post_layernorm.bias"),
    }
    out.update(_siglip_block_stack(raw, p, jcfg["n_layers"],
                                   out_proj="projection_layer"))
    out["aligner_w0"] = g("aligner.fc1.weight").T
    out["aligner_b0"] = g("aligner.fc1.bias")
    aw, ab = [], []
    i = 0
    while f"aligner.hidden_layers.{i}.weight" in raw:
        aw.append(g(f"aligner.hidden_layers.{i}.weight").T)
        ab.append(g(f"aligner.hidden_layers.{i}.bias"))
        i += 1
    if aw:
        out["aligner_wh"] = np.stack(aw)
        out["aligner_bh"] = np.stack(ab)
    _write(out, out_dir / "janus.safetensors")
    return jcfg


def _convert_lfm2_vl(raw, cfgd, out_dir: pathlib.Path):
    """LFM2-VL's siglip2 tower + pixel-unshuffle projector ->
    lfm2vl.safetensors (siglip2's linear patch embedding flattens (ph, pw,
    C) as patchify does)."""
    v = cfgd.get("vision_config", {})
    side = int(round(v.get("num_patches", 256) ** 0.5))
    lcfg = {
        "image_size": side * v.get("patch_size", 16),
        "patch_size": v.get("patch_size", 16),
        "d_model": v.get("hidden_size", 768),
        "n_layers": v.get("num_hidden_layers", 12),
        "n_heads": v.get("num_attention_heads", 12),
        "d_ff": v.get("intermediate_size", 3072),
        "ln_eps": v.get("layer_norm_eps", 1e-6),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 2048),
        "downsample": cfgd.get("downsample_factor", 2),
    }
    p = "vision_tower.vision_model."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": g(f"{p}embeddings.patch_embedding.weight").T,
        "patch_b": g(f"{p}embeddings.patch_embedding.bias"),
        "pos": g(f"{p}embeddings.position_embedding.weight"),
        "post_ln_w": g(f"{p}post_layernorm.weight"),
        "post_ln_b": g(f"{p}post_layernorm.bias"),
        "proj_ln_w": g("multi_modal_projector.layer_norm.weight"),
        "proj_ln_b": g("multi_modal_projector.layer_norm.bias"),
        "proj_w1": g("multi_modal_projector.linear_1.weight").T,
        "proj_b1": g("multi_modal_projector.linear_1.bias"),
        "proj_w2": g("multi_modal_projector.linear_2.weight").T,
        "proj_b2": g("multi_modal_projector.linear_2.bias"),
    }
    out.update(_siglip_block_stack(raw, p, lcfg["n_layers"]))
    _write(out, out_dir / "lfm2vl.safetensors")
    return lcfg


def _merger(g, pre: str, tag: str) -> dict[str, np.ndarray]:
    return {
        f"{tag}_ln_w": g(f"{pre}.norm.weight"),
        f"{tag}_ln_b": g(f"{pre}.norm.bias"),
        f"{tag}_fc1_w": g(f"{pre}.linear_fc1.weight").T,
        f"{tag}_fc1_b": g(f"{pre}.linear_fc1.bias"),
        f"{tag}_fc2_w": g(f"{pre}.linear_fc2.weight").T,
        f"{tag}_fc2_b": g(f"{pre}.linear_fc2.bias"),
    }


def _convert_qwen3vl_vision(raw, cfgd, out_dir: pathlib.Path):
    """Qwen3-VL's DeepStack ViT -> qwen3vl_vision.safetensors."""
    v = cfgd.get("vision_config", {})
    d = v.get("hidden_size", 1152)
    ds_idx = list(v.get("deepstack_visual_indexes", [8, 16, 24]))
    qcfg = {
        "patch_size": v.get("patch_size", 16),
        "d_model": d,
        "n_layers": v.get("depth", 27),
        "n_heads": v.get("num_heads", 16),
        "d_ff": v.get("intermediate_size", 4304),
        "d_out": v.get("out_hidden_size", 2048),
        "temporal_patch_size": v.get("temporal_patch_size", 2),
        "merge": v.get("spatial_merge_size", 2),
        "pos_grid": int(round(v.get("num_position_embeddings", 2304) ** 0.5)),
        "deepstack_indexes": ds_idx,
    }
    p = "visual."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": g(f"{p}patch_embed.proj.weight").reshape(d, -1).T,
        "patch_b": g(f"{p}patch_embed.proj.bias"),
        "pos": g(f"{p}pos_embed.weight"),
        **_merger(g, f"{p}merger", "merge"),
    }
    for di in range(len(ds_idx)):
        out.update(_merger(g, f"{p}deepstack_merger_list.{di}", f"ds{di}"))
    name_map = {
        "norm1.weight": ("ln1_w", False), "norm1.bias": ("ln1_b", False),
        "norm2.weight": ("ln2_w", False), "norm2.bias": ("ln2_b", False),
        "attn.qkv.weight": ("wqkv", True), "attn.qkv.bias": ("bqkv", False),
        "attn.proj.weight": ("wo", True), "attn.proj.bias": ("bo", False),
        "mlp.linear_fc1.weight": ("w1", True),
        "mlp.linear_fc1.bias": ("b1", False),
        "mlp.linear_fc2.weight": ("w2", True),
        "mlp.linear_fc2.bias": ("b2", False),
    }
    out.update(_stacks(raw, rf"{re.escape(p)}blocks\.(\d+)\.(.+)$", name_map,
                       qcfg["n_layers"]))
    _write(out, out_dir / "qwen3vl_vision.safetensors")
    return qcfg


def _convert_glm4v_vision(raw, cfgd, out_dir: pathlib.Path):
    """GLM4-V's tower + downsample + merger -> glm4v_vision.safetensors."""
    v = cfgd.get("vision_config", {})
    d = v.get("hidden_size", 1536)
    m = v.get("spatial_merge_size", 2)
    gcfg = {
        "image_size": v.get("image_size", 336),
        "patch_size": v.get("patch_size", 14),
        "d_model": d,
        "n_layers": v.get("depth", 24),
        "n_heads": v.get("num_heads", 12),
        "d_out": v.get("out_hidden_size", 4096),
        "d_proj_ff": v.get("intermediate_size", 13696),
        "temporal_patch_size": v.get("temporal_patch_size", 2),
        "merge": m,
        "rms_eps": v.get("rms_norm_eps", 1e-5),
        "attention_bias": v.get("attention_bias", False),
    }
    p = "visual."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": g(f"{p}patch_embed.proj.weight").reshape(d, -1).T,
        "patch_b": g(f"{p}patch_embed.proj.bias"),
        "post_conv_norm": g(f"{p}post_conv_layernorm.weight"),
        "pos": g(f"{p}embeddings.position_embedding.weight"),
        "post_norm": g(f"{p}post_layernorm.weight"),
        "down_w": g(f"{p}downsample.weight").transpose(2, 3, 1, 0).reshape(
            m * m * d, gcfg["d_out"]),
        "down_b": g(f"{p}downsample.bias"),
        "merge_proj": g(f"{p}merger.proj.weight").T,
        "merge_ln_w": g(f"{p}merger.post_projection_norm.weight"),
        "merge_ln_b": g(f"{p}merger.post_projection_norm.bias"),
        "merge_gate": g(f"{p}merger.gate_proj.weight").T,
        "merge_up": g(f"{p}merger.up_proj.weight").T,
        "merge_down": g(f"{p}merger.down_proj.weight").T,
    }
    name_map = {
        "norm1.weight": ("ln1_w", False), "norm2.weight": ("ln2_w", False),
        "attn.qkv.weight": ("wqkv", True), "attn.qkv.bias": ("bqkv", False),
        "attn.proj.weight": ("wo", True),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
    }
    out.update(_stacks(raw, rf"{re.escape(p)}blocks\.(\d+)\.(.+)$", name_map,
                       gcfg["n_layers"]))
    _write(out, out_dir / "glm4v_vision.safetensors")
    return gcfg


def _convert_idefics3(raw, cfgd, out_dir: pathlib.Path):
    """Idefics3's SigLIP tower + pixel-shuffle connector ->
    idefics3.safetensors.  The NaViT position bucketing of the full-size
    square grid (bucket 0 repeated per axis) is baked into ``pos``."""
    v = cfgd.get("vision_config", {})
    icfg = {
        "image_size": v.get("image_size", 364),
        "patch_size": v.get("patch_size", 14),
        "d_model": v.get("hidden_size", 1152),
        "n_layers": v.get("num_hidden_layers", 27),
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": v.get("intermediate_size", 4304),
        "ln_eps": v.get("layer_norm_eps", 1e-6),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 4096),
        "scale_factor": cfgd.get("scale_factor", 2),
    }
    p = "vision_model."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    n_side = icfg["image_size"] // icfg["patch_size"]
    bounds = np.arange(1, n_side) / n_side
    buck = np.searchsorted(bounds, np.arange(n_side) / n_side, "left")
    ids = (buck[:, None] * n_side + buck[None, :]).reshape(-1)
    out = {
        "patch_w": _conv(g(f"{p}embeddings.patch_embedding.weight")),
        "patch_b": g(f"{p}embeddings.patch_embedding.bias"),
        "pos": g(f"{p}embeddings.position_embedding.weight")[ids],
        "post_ln_w": g(f"{p}post_layernorm.weight"),
        "post_ln_b": g(f"{p}post_layernorm.bias"),
        "mm_proj": g("connector.modality_projection.proj.weight").T,
    }
    out.update(_siglip_block_stack(raw, p, icfg["n_layers"]))
    _write(out, out_dir / "idefics3.safetensors")
    return icfg


def _convert_pixtral(raw, cfgd, out_dir: pathlib.Path):
    """Pixtral's 2-D-rope tower + llava projector (mistral3's patch merger)
    -> pixtral.safetensors."""
    v = cfgd.get("vision_config", {})
    pcfg = {
        "image_size": v.get("image_size", 1024),
        "patch_size": v.get("patch_size", 16),
        "d_model": v.get("hidden_size", 1024),
        "n_layers": v.get("num_hidden_layers", 24),
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": v.get("intermediate_size", 4096),
        "rope_theta": v.get("rope_theta", 10000.0),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 5120),
    }
    p = "vision_tower."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": _conv(g(f"{p}patch_conv.weight")),
        "pre_norm": g(f"{p}ln_pre.weight"),
        "proj_w1": g("multi_modal_projector.linear_1.weight").T,
        "proj_w2": g("multi_modal_projector.linear_2.weight").T,
    }
    for hf_n, nm in (("multi_modal_projector.linear_1.bias", "proj_b1"),
                     ("multi_modal_projector.linear_2.bias", "proj_b2")):
        if hf_n in raw:
            out[nm] = g(hf_n)
    if "multi_modal_projector.patch_merger.merging_layer.weight" in raw:
        out["merge_w"] = g(
            "multi_modal_projector.patch_merger.merging_layer.weight").T
        out["input_norm"] = g("multi_modal_projector.norm.weight")
        pcfg["spatial_merge_size"] = cfgd.get("spatial_merge_size", 2)
        pcfg["rms_eps_merge"] = cfgd.get("text_config", {}).get(
            "rms_norm_eps", 1e-5)
    name_map = {
        "attention_norm.weight": "attn_norm",
        "ffn_norm.weight": "ffn_norm",
        "attention.q_proj.weight": "wq",
        "attention.k_proj.weight": "wk",
        "attention.v_proj.weight": "wv",
        "attention.o_proj.weight": "wo",
        "feed_forward.gate_proj.weight": "w_gate",
        "feed_forward.up_proj.weight": "w_up",
        "feed_forward.down_proj.weight": "w_down",
    }
    out.update(_stacks(raw, rf"{re.escape(p)}transformer\.layers\.(\d+)\.(.+)$",
                       name_map, pcfg["n_layers"]))
    _write(out, out_dir / "pixtral.safetensors")
    return pcfg


def convert_minicpmv_resampler(raw: dict[str, np.ndarray]
                               ) -> dict[str, np.ndarray]:
    """MiniCPM-V's perceiver resampler HF weights (``resampler.*``, torch
    MultiheadAttention's fused in_proj) -> ``vision_ext.minicpmv_resampler``
    params."""
    g = lambda n: np.asarray(raw["resampler." + n], np.float32)  # noqa
    inw = g("attn.in_proj_weight")       # (3d, d)
    inb = g("attn.in_proj_bias")
    d = inw.shape[1]
    return {
        "query": g("query"),
        "kv_proj": g("kv_proj.weight").T,
        "ln_q_w": g("ln_q.weight"), "ln_q_b": g("ln_q.bias"),
        "ln_kv_w": g("ln_kv.weight"), "ln_kv_b": g("ln_kv.bias"),
        "attn_q_w": inw[:d].T, "attn_q_b": inb[:d],
        "attn_k_w": inw[d:2 * d].T, "attn_k_b": inb[d:2 * d],
        "attn_v_w": inw[2 * d:].T, "attn_v_b": inb[2 * d:],
        "attn_o_w": g("attn.out_proj.weight").T,
        "attn_o_b": g("attn.out_proj.bias"),
        "ln_post_w": g("ln_post.weight"), "ln_post_b": g("ln_post.bias"),
        "mm_proj": g("proj"),
    }


def _convert_vision_tower(raw, cfgd, out_dir: pathlib.Path):
    """The CLIP tower + llava projector -> vision.safetensors."""
    v = cfgd.get("vision_config", {})
    d = v.get("hidden_size", 1024)
    L = v.get("num_hidden_layers", 24)
    vcfg = {
        "image_size": v.get("image_size", 336),
        "patch_size": v.get("patch_size", 14),
        "d_model": d,
        "n_layers": L,
        "n_heads": v.get("num_attention_heads", 16),
        "d_ff": v.get("intermediate_size", 4096),
        "layer_norm_eps": v.get("layer_norm_eps", 1e-5),
        "d_llm": cfgd.get("text_config", {}).get("hidden_size", 4096),
        "feature_layer": cfgd.get("vision_feature_layer", -2),
        "select_feature": (
            "patch" if cfgd.get("vision_feature_select_strategy", "default")
            == "default" else "cls_patch"),
    }
    p = "vision_tower.vision_model."
    g = lambda n: np.asarray(raw[n], np.float32)  # noqa: E731
    out = {
        "patch_w": _conv(g(f"{p}embeddings.patch_embedding.weight")),
        "cls": g(f"{p}embeddings.class_embedding").reshape(1, -1),
        "pos": g(f"{p}embeddings.position_embedding.weight"),
        "pre_ln_w": g(f"{p}pre_layrnorm.weight"),
        "pre_ln_b": g(f"{p}pre_layrnorm.bias"),
        "proj_w1": g("multi_modal_projector.linear_1.weight").T,
        "proj_b1": g("multi_modal_projector.linear_1.bias"),
        "proj_w2": g("multi_modal_projector.linear_2.weight").T,
        "proj_b2": g("multi_modal_projector.linear_2.bias"),
    }
    out.update(_stacks(raw, rf"{re.escape(p)}encoder\.layers\.(\d+)\.(.+)$",
                       _SIGLIP_BLOCK, L, drop_missing=True))
    _write(out, out_dir / "vision.safetensors")
    return vcfg


# the meta key and the converter of each HF vision model_type (anything
# else with tower tensors is the CLIP / llava tower)
TOWERS = {
    "siglip_vision_model": ("siglip_config", _convert_siglip_gemma3),
    "pixtral": ("pixtral_config", _convert_pixtral),
    "internvl_vision": ("internvl_config", _convert_internvl_vision),
    "llama4_vision_model": ("llama4_vision_config", _convert_llama4_vision),
    "idefics3_vision": ("idefics3_config", _convert_idefics3),
    "glm4v": ("glm4v_vision_config", _convert_glm4v_vision),
    "qwen3_vl": ("qwen3vl_vision_config", _convert_qwen3vl_vision),
    "qwen3_vl_moe": ("qwen3vl_vision_config", _convert_qwen3vl_vision),
    "janus_vision_model": ("janus_config", _convert_janus_vision),
    "siglip2_vision_model": ("lfm2vl_config", _convert_lfm2_vl),
}
