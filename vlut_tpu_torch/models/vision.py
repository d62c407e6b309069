"""CLIP vision encoder + llava projector, the image preprocessors and the
tower router (port of ``vlut_tpu/models/vision.py``).

The patchify convolution is an unfold + matmul; encoder blocks are pre-LN
MHA + tanh-GELU MLP in the stored dtype (bf16 from a checkpoint, the norms
float32), the attention an einsum-softmax-einsum in float32 with the JAX
package's bf16 rounding points; the llava projector (linear -> gelu ->
linear, yi-vl's MLP_NORM LayerNorms when present) runs in float32 and
rounds to the weights' dtype.  No Pallas kernel touches a tower, so these
are plain ``torch.matmul`` products.

Image embeddings splice into the decoder through ``forward``'s
``token_embeds`` (:func:`build_multimodal_embeds`: the prompt's text
embeddings around the projected patches).  :func:`encode_image_auto`
dispatches an image through whichever tower family a checkpoint carries.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.vision_ext import layer


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 336
    patch_size: int = 14
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    layer_norm_eps: float = 1e-5
    d_llm: int = 4096          # decoder embedding width (projector output)
    projector_layers: int = 2
    use_cls_token: bool = True
    # llava drops the CLS token and projects patch features only
    select_feature: str = "patch"  # "patch" | "cls_patch"
    # llava uses the features of a mid layer (vision_feature_layer=-2)
    feature_layer: int = -2

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _ln(x, w, b, eps):
    """LayerNorm in float32, rounded back to x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _layout(cfg: VisionConfig, rand, full) -> dict[str, Any]:
    """The tower + projector tree: ``rand(*shape)`` for the projections in
    the JAX package's draw order, ``full(shape, value, float32?)`` for the
    biases (0) and the norms (1 / 0, float32)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    layers = {
        "ln1_w": full((L, d), 1.0, True), "ln1_b": full((L, d), 0.0, True),
        "ln2_w": full((L, d), 1.0, True), "ln2_b": full((L, d), 0.0, True),
        "wq": rand(L, d, d), "bq": full((L, d), 0.0, False),
        "wk": rand(L, d, d), "bk": full((L, d), 0.0, False),
        "wv": rand(L, d, d), "bv": full((L, d), 0.0, False),
        "wo": rand(L, d, d), "bo": full((L, d), 0.0, False),
        "w1": rand(L, d, f), "b1": full((L, f), 0.0, False),
        "w2": rand(L, f, d), "b2": full((L, d), 0.0, False),
    }
    n_pos = cfg.n_patches + (1 if cfg.use_cls_token else 0)
    params: dict[str, Any] = {"patch_w": rand(3 * cfg.patch_size ** 2, d)}
    if cfg.use_cls_token:
        params["cls"] = rand(1, d)
    params.update({
        "pos": rand(n_pos, d),
        "pre_ln_w": full((d,), 1.0, True), "pre_ln_b": full((d,), 0.0, True),
        "layers": layers,
        "proj_w1": rand(d, cfg.d_llm),
        "proj_b1": full((cfg.d_llm,), 0.0, False),
        "proj_w2": rand(cfg.d_llm, cfg.d_llm),
        "proj_b2": full((cfg.d_llm,), 0.0, False),
    })
    return params


def _full(dtype, device):
    def full(shape, v, f32):
        return torch.full(shape, v, device=device,
                          dtype=torch.float32 if f32 else dtype)
    return full


def init_params(cfg: VisionConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu") -> dict[str, Any]:
    """Random tower + projector weights from a numpy generator, the JAX
    package's draws (projections N(0, 0.02), biases 0, norms 1 / 0 in
    float32)."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        a = rng.standard_normal(shape) * 0.02
        if dtype == torch.bfloat16:
            # one rounding from float64 to bf16's 8 significant bits, half
            # to even (a float32 step first could round twice)
            m, e = np.frexp(a)
            a = np.ldexp(np.rint(m * 256.0) / 256.0, e)
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype)

    return _layout(cfg, rand, _full(dtype, device))


def init_params_fast(cfg: VisionConfig, seed: int = 0, dtype=torch.bfloat16,
                     device="cpu") -> dict[str, Any]:
    """:func:`init_params`' layout drawn on ``device`` by a seeded
    ``torch.Generator`` (not the JAX package's draws): a full-width tower
    in a fraction of a second."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dtype)

    return _layout(cfg, rand, _full(dtype, device))


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_patches, 3*patch*patch): the conv-as-matmul
    unfold (channels last, row-major patches)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


@full_float32()
def encode_tower(params: dict[str, Any], cfg: VisionConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> the features of the llava feature layer, CLS dropped
    under the "patch" strategy (the projector's input)."""
    b = images.shape[0]
    x = (patchify(images.to(torch.float32), cfg.patch_size)
         @ params["patch_w"].to(torch.float32)).to(params["patch_w"].dtype)
    if cfg.use_cls_token:
        cls = params["cls"].expand(b, 1, cfg.d_model).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos"][None].to(x.dtype)
    x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], cfg.layer_norm_eps)

    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    keep = (cfg.n_layers + cfg.feature_layer + 1 if cfg.feature_layer < 0
            else cfg.feature_layer + 1)
    scale = float(np.float32(np.sqrt(hd)))
    for i in range(keep):
        lp = layer(params["layers"], i)
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        t = h.shape[1]
        q = (h @ lp["wq"] + lp["bq"]).reshape(b, t, H, hd)
        k = (h @ lp["wk"] + lp["bk"]).reshape(b, t, H, hd)
        v = (h @ lp["wv"] + lp["bv"]).reshape(b, t, H, hd)
        scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                              k.to(torch.float32)) / scale
        p = torch.softmax(scores, dim=-1)
        att = torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32)
                           ).reshape(b, t, cfg.d_model).to(x.dtype)
        x = x + att @ lp["wo"] + lp["bo"]
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        m = F.gelu((h @ lp["w1"] + lp["b1"]).to(torch.float32),
                   approximate="tanh").to(x.dtype)
        x = x + m @ lp["w2"] + lp["b2"]
    if cfg.select_feature == "patch" and cfg.use_cls_token:
        x = x[:, 1:]
    return x


@full_float32()
def encode_image(params: dict[str, Any], cfg: VisionConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float in ~[-2, 2] -> (B, n_tokens, d_llm) projected
    embeddings, ready to splice into the decoder."""
    return llava_project(params, encode_tower(params, cfg, images))


@full_float32()
def llava_project(params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """llava projector: linear -> tanh gelu -> linear in float32, rounded to
    the weights' dtype; yi-vl's MLP_NORM variant puts a LayerNorm after
    each linear when ``proj_ln{1,2}_{w,b}`` are present."""
    f32 = torch.float32

    def _pln(v, nm):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return ((v - mu) * torch.rsqrt(var + 1e-5)
                * params[f"{nm}_w"].to(f32) + params[f"{nm}_b"].to(f32))

    y = x.to(f32) @ params["proj_w1"].to(f32)
    y = y + params["proj_b1"].to(f32)
    if "proj_ln1_w" in params:
        y = _pln(y, "proj_ln1")
    y = F.gelu(y, approximate="tanh")
    y = y @ params["proj_w2"].to(f32)
    y = y + params["proj_b2"].to(f32)
    if "proj_ln2_w" in params:
        y = _pln(y, "proj_ln2")
    return y.to(params["proj_w2"].dtype)


# image normalization per tower family (HF image-processor defaults)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_HALF = (0.5, 0.5, 0.5)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _load_rgb(path_or_array, image_size: int, mean, std) -> np.ndarray:
    """An (H, W, 3) array in [0, 1] as it is, or an image file resized to
    ``image_size`` (Pillow, imported here only), normalized per channel."""
    if isinstance(path_or_array, np.ndarray):
        arr = path_or_array
    else:
        from PIL import Image

        img = Image.open(path_or_array).convert("RGB")
        img = img.resize((image_size, image_size))
        arr = np.asarray(img, np.float32) / 255.0
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    return ((arr - m) / s).astype(np.float32)


def preprocess_image(path_or_array, image_size: int) -> np.ndarray:
    """Load + resize + CLIP-normalize an image to (H, W, 3) in ~[-2, 2]."""
    return _load_rgb(path_or_array, image_size, _CLIP_MEAN, _CLIP_STD)


def build_multimodal_embeds(model, image_embeds: torch.Tensor,
                            prefix_ids: list[int],
                            suffix_ids: list[int]) -> torch.Tensor:
    """Text-embed prefix + image rows + text-embed suffix -> (T, d), in the
    embedding's dtype, on the model's device."""
    embed = model.embed
    parts = []
    if prefix_ids:
        parts.append(embed[torch.tensor(prefix_ids, device=embed.device)])
    parts.append(image_embeds.to(embed.device, embed.dtype))
    if suffix_ids:
        parts.append(embed[torch.tensor(suffix_ids, device=embed.device)])
    return torch.cat(parts, dim=0)


def _image(path_or_array, size, mean, std, device) -> torch.Tensor:
    """(1, size, size, 3) float32 on ``device``."""
    img = _load_rgb(path_or_array, size, mean, std)
    return torch.from_numpy(img).to(device)[None]


@full_float32()
def encode_image_auto(model_dir, image, device=None):
    """Dispatch an image (a file, or an (H, W, 3) array in [0, 1]) through
    whichever tower family the checkpoint carries, in the JAX package's
    order: CLIP/llava, gemma3 SigLIP, pixtral, qwen2/2.5-vl, internvl,
    llama4-vision, idefics3, glm4v, qwen3vl, janus-pro, lfm2-vl.  Returns
    (embeds (n_tokens, d_llm), family name) -- for qwen3vl the name is
    ("qwen3vl-deepstack", deepstack features) -- or (None, None) when the
    checkpoint has no vision sidecar.  The tower runs on ``device`` (the
    GPU unless the CPU is asked for)."""
    from vlut_tpu_torch.convert import checkpoint as ck
    from vlut_tpu_torch.device import resolve_device
    from vlut_tpu_torch.models import qwen_vision as qv
    from vlut_tpu_torch.models import vision_ext as ve
    from vlut_tpu_torch.models import vision_wave3 as w3

    dev = resolve_device(device)

    vcfg, vparams = ck.load_vision(model_dir, dev)
    if vcfg is not None:
        img = torch.from_numpy(preprocess_image(image, vcfg.image_size))
        return encode_image(vparams, vcfg, img.to(dev)[None])[0], \
            "clip-llava"

    scfg, sp, _ = ck.load_siglip(model_dir, dev)
    if scfg is not None:
        img = _image(image, scfg.image_size, _HALF, _HALF, dev)
        feats = ve.siglip_forward(sp, scfg, img)
        return ve.gemma3_project(sp, scfg, feats)[0], "gemma3-siglip"

    pcfg, pp, _ = ck.load_pixtral(model_dir, dev)
    if pcfg is not None:
        img = _image(image, pcfg.image_size, _CLIP_MEAN, _CLIP_STD, dev)
        feats = ve.pixtral_forward(pp, pcfg, img)
        side = pcfg.image_size // pcfg.patch_size
        return ve.pixtral_project(pp, feats, cfg=pcfg,
                                  grid_hw=(side, side)), "pixtral"

    qcfg, qp, _ = ck.load_qwen_vision(model_dir, dev)
    if qcfg is not None:
        img = _load_rgb(image, 224, _CLIP_MEAN, _CLIP_STD)
        patches, grid = qv.patchify(img.transpose(2, 0, 1), qcfg)
        return qv.vision_forward(qp, qcfg, torch.from_numpy(
            np.ascontiguousarray(patches)).to(dev), grid), "qwen-vl"

    icfg, ip, _ = ck.load_internvl_vision(model_dir, dev)
    if icfg is not None:
        img = _image(image, icfg.image_size, _IMAGENET_MEAN, _IMAGENET_STD,
                     dev)
        feats = w3.internvl_forward(ip, icfg, img)
        return w3.internvl_project(ip, icfg, feats)[0], "internvl"

    lcfg, lp, _ = ck.load_llama4_vision(model_dir, dev)
    if lcfg is not None:
        img = _image(image, lcfg.image_size, _HALF, _HALF, dev)
        feats = w3.llama4_vision_forward(lp, lcfg, img)
        return w3.llama4_project(lp, lcfg, feats)[0], "llama4-vision"

    i3cfg, scale, i3p, _ = ck.load_idefics3(model_dir, dev)
    if i3cfg is not None:
        img = _image(image, i3cfg.image_size, _HALF, _HALF, dev)
        feats = ve.siglip_forward(i3p, i3cfg, img)
        return w3.idefics3_project(i3p, feats, scale)[0], "idefics3"

    gcfg, gp, _ = ck.load_glm4v_vision(model_dir, dev)
    if gcfg is not None:
        img = _load_rgb(image, gcfg.image_size, _HALF, _HALF)
        qvc = qv.QwenVisionConfig(
            depth=gcfg.n_layers, embed_dim=gcfg.d_model,
            n_heads=gcfg.n_heads, mlp_dim=gcfg.d_out,
            patch_size=gcfg.patch_size,
            temporal_patch_size=gcfg.temporal_patch_size,
            spatial_merge_size=gcfg.merge)
        patches, grid = qv.patchify(img.transpose(2, 0, 1), qvc)
        return w3.glm4v_vision_forward(gp, gcfg, torch.from_numpy(
            np.ascontiguousarray(patches)).to(dev), grid), "glm4v"

    q3cfg, q3p, _ = ck.load_qwen3vl_vision(model_dir, dev)
    if q3cfg is not None:
        img = _load_rgb(image, q3cfg.pos_grid * q3cfg.patch_size,
                        _HALF, _HALF)
        qvc = qv.QwenVisionConfig(
            depth=q3cfg.n_layers, embed_dim=q3cfg.d_model,
            n_heads=q3cfg.n_heads, mlp_dim=q3cfg.d_ff,
            patch_size=q3cfg.patch_size,
            temporal_patch_size=q3cfg.temporal_patch_size,
            spatial_merge_size=q3cfg.merge)
        patches, grid = qv.patchify(img.transpose(2, 0, 1), qvc)
        main, deepstack = w3.qwen3vl_vision_forward(
            q3p, q3cfg, torch.from_numpy(
                np.ascontiguousarray(patches)).to(dev), grid)
        # the caller scatters the deepstack planes over the image span and
        # passes them as forward(deepstack_embeds=...)
        return main, ("qwen3vl-deepstack", tuple(deepstack))

    jcfg, jp, _ = ck.load_janus_vision(model_dir, dev)
    if jcfg is not None:
        img = _image(image, jcfg.image_size, _IMAGENET_MEAN, _IMAGENET_STD,
                     dev)
        feats = ve.siglip_forward(jp, jcfg, img, act="exact")
        return w3.janus_aligner(jp, feats)[0], "janus-pro"

    l2cfg, factor, l2p, _ = ck.load_lfm2vl_vision(model_dir, dev)
    if l2cfg is not None:
        img = _image(image, l2cfg.image_size, _HALF, _HALF, dev)
        feats = ve.siglip_forward(l2p, l2cfg, img)
        return w3.lfm2vl_project(l2p, feats, factor)[0], "lfm2-vl"

    return None, None
