"""Selective state-space models: Mamba and Mamba2 (port of
vlut_tpu/models/ssm.py).

Mamba's recurrence, per channel d and state s,

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,      y_t = C_t . h_t + D x_t,

runs at prefill as the JAX package's ``jax.lax.associative_scan`` over T,
reproduced level for level (:func:`associative_scan`: pairs combined, the
halves scanned by recursion, the odd results combined with the even
elements, interleaved), with its ``combine`` ``(a1*b1, b1*a2 + b2)``.
XLA's CPU contracts ``b1*a2 + b2`` into one fused multiply-add, and so
does ``torch.addcmul`` (:func:`_fma`), so the scan rounds as the JAX one
does.  At T = 1 (a decode step) the incoming state folds in as
``fma(dA, h0, dBx)``, as ``dBx.at[:, 0].add(dA[:, 0] * h0)`` compiles.
The scan's (B, T, d_inner, d_state) float32 intermediates are cut into
chunks of d_inner (channels never mix in the recurrence) so that a long
prefill group fits the card.

Per-sequence state is ``{"conv": (L, B, d_conv-1, C), "ssm": (L, B, ...)}``
float32, the recurrent counterpart of KV slots.  :func:`forward` returns
the new state (or writes it into the given state's tensors in place, with
``inplace=True``: the engine's CUDA-graphed step holds them by address).
Left-padded batches carry a ``valid`` mask: pads add nothing to the conv
window or the state, so a padded row ends in its unpadded state.

The in/out projections are packed ternary and run through
``ops.matmul.ternary_matmul`` (the fused-quant GEMM at M <= 64, the tiled
GEMM above); the small tensors (conv, x_proj, dt_proj, A_log, D, norms)
stay float32, and the embedding bf16.  The head is float32 ``x @ W``: a
float32 copy of the (tied) head is made once at load.  Rounding points
follow the JAX package: the RMSNorm returns its input's dtype, ``y`` is
rounded to it before ``out_proj``, the residual adds in bf16.

Elementwise transcendentals (exp, softplus as ``logaddexp(x, 0)``, silu as
``x * sigmoid(x)``) round apart from XLA's by an ulp; the tests hold the
logits within 2e-2 of the largest and the greedy tokens equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from vlut_tpu_torch.device import full_float32, resolve_device
from vlut_tpu_torch.ops.matmul import ternary_matmul
from vlut_tpu_torch.ops.packing import (
    DEFAULT_BLOCK,
    TernaryTensor,
    pack_ternary,
    padded_k,
)

# float32 bytes one chunk of the scan's (B, T, chunk, state) tensors may hold
SCAN_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    rms_eps: float = 1e-5
    weight_fmt: str = "i2"
    max_seq_len: int = 2048
    tie_embeddings: bool = True

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


@dataclasses.dataclass(frozen=True)
class Mamba2Dims:
    d_inner: int
    n_heads: int
    head_dim: int
    n_groups: int
    d_state: int
    d_conv: int
    rms_eps: float = 1e-5
    # "gated": norm(y * silu(z)) (mamba2/granite); "norm_first": norm(y) *
    # silu(z) (falcon-h1 mamba_norm_before_gate); "gate_only": y * silu(z)
    # with no norm weight (falcon-h1 mamba_rms_norm=False)
    norm_mode: str = "gated"
    time_limit: tuple[float, float] = (0.0, float("inf"))


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    head_dim: int = 64
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    rms_eps: float = 1e-5
    weight_fmt: str = "i2"
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    time_limit: tuple[float, float] = (0.0, float("inf"))

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    def dims(self) -> Mamba2Dims:
        return Mamba2Dims(
            d_inner=self.d_inner, n_heads=self.n_heads,
            head_dim=self.head_dim, n_groups=self.n_groups,
            d_state=self.d_state, d_conv=self.d_conv,
            rms_eps=self.rms_eps, time_limit=tuple(self.time_limit))


# Published widths served at full width on the card (random weights):
# state-spaces/mamba-2.8b-hf and mistralai/Mamba-Codestral-7B-v0.1
PRESETS: dict[str, Any] = {
    "mamba_2_8b": MambaConfig(
        vocab_size=50280, d_model=2560, n_layers=64, d_state=16, d_conv=4,
        expand=2, dt_rank=160, max_seq_len=2048, tie_embeddings=True),
    "codestral_mamba_7b": Mamba2Config(
        vocab_size=32768, d_model=4096, n_layers=64, n_heads=128,
        head_dim=64, d_state=128, d_conv=4, expand=2, n_groups=8,
        max_seq_len=2048, tie_embeddings=False),
}


def _proj_widths(cfg) -> dict[str, tuple[int, int]]:
    """(K, N) of the packed projections."""
    if isinstance(cfg, Mamba2Config):
        n_in = cfg.d_inner + cfg.conv_dim + cfg.n_heads
        return {"in_proj": (cfg.d_model, n_in),
                "out_proj": (cfg.d_inner, cfg.d_model)}
    return {"in_proj": (cfg.d_model, 2 * cfg.d_inner),
            "out_proj": (cfg.d_inner, cfg.d_model)}


# --- the model ----------------------------------------------------------

class RecurrentLayers(nn.Module):
    """The stacked (L, ...) layer tensors of a Mamba / Mamba2 checkpoint as
    buffers (``in_proj`` / ``out_proj`` as ``<name>.packed`` (L, Kp/4, Np)
    uint8 and ``<name>.scale`` (L,) float32), with each layer's
    :class:`TernaryTensor` views."""

    def __init__(self, tree: dict[str, Any],
                 widths: dict[str, tuple[int, int]]):
        super().__init__()
        self.widths = widths
        self.names = []
        for name, v in tree.items():
            if isinstance(v, dict):
                k, _ = widths[name]
                packed, scale = v["packed"], v["scale"].to(torch.float32)
                kb = DEFAULT_BLOCK["i2"]
                if packed.shape[1] * 4 != padded_k(k, "i2", kb):
                    raise ValueError(f"{name}: packed {tuple(packed.shape)} "
                                     f"does not fit K={k}")
                self.register_buffer(name + "_packed", packed)
                self.register_buffer(name + "_scale", scale)
            else:
                self.register_buffer(name, v)
                self.names.append(name)
        self.n_layers = tree["in_proj"]["packed"].shape[0]
        # per-layer weight-scale vectors, made once (the kernels' epilogue)
        self._w_scale = {
            name: [self._tensor(name, i, None).scale_vector()
                   for i in range(self.n_layers)]
            for name in widths}

    def _tensor(self, name: str, i: int, ws) -> TernaryTensor:
        k, n = self.widths[name]
        packed = getattr(self, name + "_packed")[i]
        scale = getattr(self, name + "_scale")[i] if ws is None else ws
        return TernaryTensor(packed, scale, k, n, "i2", DEFAULT_BLOCK["i2"])

    def proj(self, name: str, i: int) -> TernaryTensor:
        return self._tensor(name, i, self._w_scale[name][i])

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        return {n: getattr(self, n)[i] for n in self.names}

    def tree(self) -> dict[str, Any]:
        out = {n: getattr(self, n) for n in self.names}
        for name in self.widths:
            out[name] = {"packed": getattr(self, name + "_packed"),
                         "scale": getattr(self, name + "_scale")}
        return out


class RecurrentLM(nn.Module):
    """A Mamba or Mamba2 LM on one device: ``embed`` (V, d), ``final_norm``,
    the stacked ``layers`` and ``head`` (V, d) float32 (``lm_head`` when
    the checkpoint has one, else the embedding)."""

    def __init__(self, cfg, tree: dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("embed", tree["embed"])
        self.register_buffer("final_norm", tree["final_norm"])
        self.layers = RecurrentLayers(tree["layers"], _proj_widths(cfg))
        self.has_lm_head = "lm_head" in tree
        if self.has_lm_head:
            self.register_buffer("lm_head", tree["lm_head"])
            head = tree["lm_head"].t()
        else:
            head = tree["embed"]
        self.register_buffer("head", head.to(torch.float32).contiguous(),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def n_logits(self) -> int:
        return self.head.shape[0]

    def tree(self) -> dict[str, Any]:
        out = {"embed": self.embed, "final_norm": self.final_norm,
               "layers": self.layers.tree()}
        if self.has_lm_head:
            out["lm_head"] = self.lm_head
        return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


class TreeLM(nn.Module):
    """A float-weight family's model (RWKV, the hybrids): the checkpoint's
    tree of tensors (``params``, nested dicts; a list of per-layer trees
    for a ``layers_tuple`` checkpoint), registered as buffers."""

    def __init__(self, cfg, tree: dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = tree

        def register(node, prefix):
            items = (node.items() if isinstance(node, dict)
                     else enumerate(node))
            for k, v in items:
                if torch.is_tensor(v):
                    self.register_buffer(f"{prefix}{k}".replace(".", "_"), v)
                else:
                    register(v, f"{prefix}{k}_")
        register(tree, "")

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def tree(self) -> dict[str, Any]:
        return self.params


def _pack(trits: np.ndarray, scale) -> dict[str, torch.Tensor]:
    t = pack_ternary(trits, scale, "i2")
    return {"packed": t.packed, "scale": t.scale}


def init_params(cfg: MambaConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu") -> RecurrentLM:
    """The JAX package's ``init_params``: the same numpy draws in the same
    order, so both packages make identical weights from one seed."""
    rng = np.random.default_rng(seed)
    di, ds, dr, L = cfg.d_inner, cfg.d_state, cfg.dt_rank_, cfg.n_layers

    def tern(k, n):
        packs = [_pack(rng.integers(-1, 2, size=(k, n), dtype=np.int8),
                       np.float32(0.05)) for _ in range(L)]
        return {"packed": torch.stack([p["packed"] for p in packs]),
                "scale": torch.stack([p["scale"] for p in packs])}

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    layers = {
        "in_proj": tern(cfg.d_model, 2 * di),
        "out_proj": tern(di, cfg.d_model),
        "norm": torch.ones((L, cfg.d_model)),
        "conv_w": f32(rng.standard_normal((L, cfg.d_conv, di)) * 0.2),
        "conv_b": torch.zeros((L, di)),
        "x_proj": f32(rng.standard_normal((L, di, dr + 2 * ds)) * 0.05),
        "dt_proj_w": f32(rng.standard_normal((L, dr, di)) * 0.1),
        "dt_proj_b": f32(np.log(np.expm1(rng.uniform(1e-3, 0.1, (L, di))))),
        "A_log": f32(np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32),
                                    (L, di, 1)))),
        "D": torch.ones((L, di)),
    }
    embed = f32(rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.02)
    tree = {"embed": embed.to(dtype), "final_norm": torch.ones(cfg.d_model),
            "layers": layers}
    return RecurrentLM(cfg, _tree_to(tree, resolve_device(device)))


@torch.no_grad()
def init_params_fast(cfg, seed: int = 0, device=None) -> RecurrentLM:
    """Random weights made on the device from one generator (full-width
    serving runs): packed i2 bytes of valid trits at scale 0.05 (0.02 for
    Mamba2's wider projections), the float tensors at the scales of
    :func:`init_params`, A_log as Mamba's ``log(1..d_state)`` (Mamba2: one
    decay per head in log(1..16))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = cfg.n_layers

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    def tern(name, scale):
        k, n = _proj_widths(cfg)[name]
        kp, np_ = padded_k(k, "i2"), -(-n // 128) * 128
        kb = DEFAULT_BLOCK["i2"]
        packed = torch.empty((L, kp // 4, np_), dtype=torch.uint8,
                             device=dev)
        for i in range(L):
            # fields {0, 1, 2} (trit + 1), zero trits past K and N; byte
            # [block b, row j] holds the fields of rows b*kb + q*kb/4 + j
            f = torch.randint(0, 3, (kp, np_), generator=gen, device=dev,
                              dtype=torch.uint8)
            f[k:] = 1
            f[:, n:] = 1
            f = f.reshape(kp // kb, 4, kb // 4, np_)
            packed[i] = (f[:, 0] | f[:, 1] << 2 | f[:, 2] << 4
                         | f[:, 3] << 6).reshape(kp // 4, np_)
        return {"packed": packed,
                "scale": torch.full((L,), scale, device=dev)}

    if isinstance(cfg, Mamba2Config):
        h, cd = cfg.n_heads, cfg.conv_dim
        layers = {
            "in_proj": tern("in_proj", 0.02),
            "out_proj": tern("out_proj", 0.02),
            "norm": torch.ones((L, cfg.d_model), device=dev),
            "conv_w": randn(L, cfg.d_conv, cd, s=0.2),
            "conv_b": randn(L, cd, s=0.1),
            "dt_bias": randn(L, h, s=0.2),
            "A_log": torch.log(torch.rand((L, h), generator=gen, device=dev)
                               * 15 + 1),
            "D": torch.ones((L, h), device=dev),
            "norm_w": torch.ones((L, cfg.d_inner), device=dev),
        }
    else:
        di, ds, dr = cfg.d_inner, cfg.d_state, cfg.dt_rank_
        dt = torch.rand((L, di), generator=gen, device=dev) * 0.099 + 1e-3
        layers = {
            "in_proj": tern("in_proj", 0.05),
            "out_proj": tern("out_proj", 0.05),
            "norm": torch.ones((L, cfg.d_model), device=dev),
            "conv_w": randn(L, cfg.d_conv, di, s=0.2),
            "conv_b": torch.zeros((L, di), device=dev),
            "x_proj": randn(L, di, dr + 2 * ds, s=0.05),
            "dt_proj_w": randn(L, dr, di, s=0.1),
            "dt_proj_b": torch.log(torch.expm1(dt)),
            "A_log": torch.log(torch.arange(1, ds + 1, device=dev,
                                            dtype=torch.float32)
                               ).expand(L, di, ds).contiguous(),
            "D": torch.ones((L, di), device=dev),
        }
    tree = {"embed": randn(cfg.vocab_size, cfg.d_model, s=0.02).to(
                torch.bfloat16),
            "final_norm": torch.ones(cfg.d_model, device=dev),
            "layers": layers}
    if not cfg.tie_embeddings:
        tree["lm_head"] = randn(cfg.d_model, cfg.vocab_size, s=0.02).to(
            torch.bfloat16)
    return RecurrentLM(cfg, tree)


def init_state(cfg: MambaConfig, batch: int, device="cpu"
               ) -> dict[str, torch.Tensor]:
    """Per-sequence recurrent state (the recurrent 'KV cache')."""
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                             cfg.d_inner), device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.d_state),
                           device=dev),
    }


def init_state2(cfg: Mamba2Config, batch: int, device="cpu"
                ) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                             cfg.conv_dim), device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.head_dim,
                            cfg.d_state), device=dev),
    }


# --- math ---------------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once (``torch.addcmul`` is a fused multiply-add)."""
    return torch.addcmul(c, a, b)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rms32(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 (RWKV's and the hybrids' norm)."""
    xf = x.to(torch.float32)
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, returned in the input's dtype."""
    return rms32(x, w, eps).to(x.dtype)


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int
                ) -> torch.Tensor:
    shape = list(even.shape)
    shape[dim] = even.shape[dim] + odd.shape[dim]
    out = even.new_empty(shape)
    idx = [slice(None)] * len(shape)
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(combine, elems: list[torch.Tensor], dim: int = 1
                     ) -> list[torch.Tensor]:
    """``jax.lax.associative_scan`` (JAX 0.9's recursion, element for
    element): combine [0:-1:2] with [1::2], scan the result, combine its
    elements with [2::2], put the first element before them and interleave
    with the scanned ones."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop, step):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = combine([sl(e, 0, -1, 2) for e in elems],
                      [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1, None) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1, None), r], dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor
              ) -> torch.Tensor:
    """h_t = dA_t * h_{t-1} + dBx_t over axis 1 (T), h0 folded into step 0.

    dA, dBx: (B, T, d_inner, d_state); h0: (B, d_inner, d_state)."""
    dBx = torch.cat([_fma(dA[:, :1], h0[:, None], dBx[:, :1]), dBx[:, 1:]], 1)

    def combine(a, b):
        return [a[0] * b[0], _fma(b[0], a[1], b[1])]

    return associative_scan(combine, [dA, dBx], 1)[1]


def _chunks(width: int, per_channel_bytes: int):
    """Channel ranges of at most :data:`SCAN_CHUNK_BYTES` each."""
    step = max(1, min(width, SCAN_CHUNK_BYTES // max(1, per_channel_bytes)))
    return [(c, min(width, c + step)) for c in range(0, width, step)]


def _causal_conv(conv_state: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None, valid=None):
    """Depthwise causal conv over T with the carried window: returns
    (sum of the taps [+ bias], new window).  Taps add in order.  With a
    ``valid`` mask of a left-padded batch (pads zero in ``x``) the carried
    window moves past each row's pads, next to its first real token: a
    padded row continues its state as an unpadded one (with a zero window,
    as a fresh row has, nothing moves)."""
    t, dc = x.shape[1], w.shape[0]
    win = torch.cat([conv_state.to(torch.float32), x], 1)
    if valid is not None:
        pads = (~valid).sum(1, keepdim=True)  # (B, 1)
        j = torch.arange(win.shape[1], device=x.device)[None]
        src = torch.where(j < pads, j + dc - 1,
                          torch.where(j < pads + dc - 1, j - pads, j))
        win = win.gather(1, src[..., None].expand(-1, -1, win.shape[2]))
    acc = win[:, 0:t] * w[0]
    for i in range(1, dc):
        acc = acc + win[:, i:i + t] * w[i]
    if b is not None:
        acc = acc + b
    return acc, win[:, win.shape[1] - (dc - 1):]


def _mamba_mix(layers: RecurrentLayers, i: int, cfg: MambaConfig,
               x: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor, valid=None, impl: str = "auto"):
    """One mamba mixer over (B, T, d) with the incoming state; returns (y,
    new conv window, new ssm state)."""
    b, t, _ = x.shape
    di, ds, dr = cfg.d_inner, cfg.d_state, cfg.dt_rank_
    lp = layers.layer(i)
    xz = ternary_matmul(x, layers.proj("in_proj", i), impl=impl)
    xi, z = xz[..., :di].to(torch.float32), xz[..., di:].to(torch.float32)
    if valid is not None:
        xi = torch.where(valid[..., None], xi, 0.0)
    conv, new_conv = _causal_conv(conv_state, xi, lp["conv_w"], lp["conv_b"],
                                  valid)
    xc = silu(conv)
    if valid is not None:
        # the conv bias makes xc nonzero on zeroed inputs: the SSM input at
        # a pad must be exactly 0
        xc = torch.where(valid[..., None], xc, 0.0)
    proj = xc @ lp["x_proj"]
    dt = softplus(proj[..., :dr] @ lp["dt_proj_w"] + lp["dt_proj_b"])
    if valid is not None:
        # a pad's step is the identity (dA 1, dBx 0), so a carried state
        # passes the pads unchanged (the JAX package's decays there; from a
        # zero state the two agree bit for bit)
        dt = torch.where(valid[..., None], dt, 0.0)
    B = proj[..., dr:dr + ds]
    C = proj[..., dr + ds:]
    A = -torch.exp(lp["A_log"])  # (di, ds)
    ys, finals = [], []
    for c0, c1 in _chunks(di, b * t * ds * 4):
        dA = torch.exp(dt[:, :, c0:c1, None] * A[c0:c1])
        dBx = dt[:, :, c0:c1, None] * B[:, :, None, :] * xc[:, :, c0:c1,
                                                            None]
        hs = _ssm_scan(dA, dBx, ssm_state[:, c0:c1])
        ys.append((hs @ C[..., None])[..., 0])
        finals.append(hs[:, -1])
        del dA, dBx, hs
    y = ys[0] if len(ys) == 1 else torch.cat(ys, -1)
    y = y + lp["D"] * xc
    y = y * silu(z)
    out = ternary_matmul(y.to(x.dtype), layers.proj("out_proj", i), impl=impl)
    new_ssm = finals[0] if len(finals) == 1 else torch.cat(finals, 1)
    return out, new_conv, new_ssm


def mamba2_core(zxbcdt: torch.Tensor, conv_state: torch.Tensor,
                ssm_state: torch.Tensor, lp: dict[str, torch.Tensor],
                md: Mamba2Dims, valid=None):
    """The SSD mixer given the in_proj output (B, T, d_inner + conv_dim +
    n_heads); returns (y before out_proj, new conv window, new ssm state
    (B, H, head_dim, N)).  Shared by Mamba2 (ternary projections) and the
    hybrids (float projections)."""
    b, t, _ = zxbcdt.shape
    di, H, hd = md.d_inner, md.n_heads, md.head_dim
    G, N = md.n_groups, md.d_state
    conv_dim = di + 2 * G * N
    z = zxbcdt[..., :di].to(torch.float32)
    xbc = zxbcdt[..., di:di + conv_dim].to(torch.float32)
    dt = zxbcdt[..., di + conv_dim:].to(torch.float32)
    if valid is not None:
        xbc = torch.where(valid[..., None], xbc, 0.0)
    xbc, new_conv = _causal_conv(conv_state, xbc, lp["conv_w"],
                                 lp.get("conv_b"))
    xbc = silu(xbc)
    if valid is not None:
        xbc = torch.where(valid[..., None], xbc, 0.0)
    x = xbc[..., :di].reshape(b, t, H, hd)
    rep = H // G
    Bm = xbc[..., di:di + G * N].reshape(b, t, G, N).repeat_interleave(rep, 2)
    Cm = xbc[..., di + G * N:].reshape(b, t, G, N).repeat_interleave(rep, 2)
    dt = softplus(dt + lp["dt_bias"])
    lo, hi = md.time_limit
    if lo > 0.0 or hi != float("inf"):
        dt = dt.clamp(lo, hi)
    if valid is not None:
        # pads are identity steps: exp(dt*A) = 1 needs dt = 0
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(lp["A_log"].to(torch.float32))  # (H,)
    dA = torch.exp(dt * A)  # (B, T, H)

    def combine(a, b_):
        return [a[0] * b_[0], _fma(b_[0][..., None, None], a[1], b_[1])]

    ys, finals = [], []
    for h0, h1 in _chunks(H, b * t * hd * N * 4):
        dBx = (dt[:, :, h0:h1, None] * Bm[:, :, h0:h1])[..., None, :] * x[
            :, :, h0:h1, :, None]  # (B, T, h, hd, N)
        da = dA[:, :, h0:h1]
        dBx = torch.cat([_fma(da[:, :1, :, None, None],
                              ssm_state[:, None, h0:h1], dBx[:, :1]),
                         dBx[:, 1:]], 1)
        hs = associative_scan(combine, [da, dBx], 1)[1]
        ys.append((hs @ Cm[:, :, h0:h1, :, None])[..., 0])
        finals.append(hs[:, -1])
        del dBx, hs
    y = ys[0] if len(ys) == 1 else torch.cat(ys, 2)
    y = y + lp["D"].to(torch.float32)[:, None] * x
    y = y.reshape(b, t, di)
    if md.norm_mode == "gated":
        # MambaRMSNormGated: the gate before the norm
        y = y * silu(z)
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + md.rms_eps)
        y = y * lp["norm_w"].to(torch.float32)
    elif md.norm_mode == "norm_first":
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + md.rms_eps)
        y = y * lp["norm_w"].to(torch.float32) * silu(z)
    else:  # "gate_only"
        y = y * silu(z)
    new_ssm = finals[0] if len(finals) == 1 else torch.cat(finals, 1)
    return y, new_conv, new_ssm


def _head(model: RecurrentLM, cfg, x: torch.Tensor, logits_last_only: bool):
    x = _rms(x, model.final_norm, cfg.rms_eps)
    if logits_last_only:
        x = x[:, -1:]
    return x.to(torch.float32) @ model.head.t()


def layer_output(x: torch.Tensor) -> torch.Tensor:
    """Every family's layer output passes here (Mamba, Mamba2, RWKV, the
    hybrids): the identity, and the point where ``bench/recurrent_zoo.py``
    records or replaces a layer's output."""
    return x


def _keep(hold, old, new):
    """``new``, with the rows ``hold`` marks kept at ``old``."""
    if hold is None:
        return new
    return torch.where(hold.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)


def _run(model: RecurrentLM, cfg, tokens, state, logits_last_only, inplace,
         hold, mixer):
    b = tokens.shape[0]
    x = model.embed[tokens]
    carry = state is not None
    st = state if carry else (init_state2 if isinstance(cfg, Mamba2Config)
                              else init_state)(cfg, b, model.device)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        h = _rms(x, model.layers.norm[i], cfg.rms_eps)
        y, new_conv, new_ssm = mixer(i, h, st["conv"][i], st["ssm"][i])
        x = layer_output(x + y.to(x.dtype))
        if inplace:
            st["conv"][i].copy_(_keep(hold, st["conv"][i], new_conv))
            st["ssm"][i].copy_(_keep(hold, st["ssm"][i], new_ssm))
        elif carry:
            convs.append(new_conv)
            ssms.append(new_ssm)
    logits = _head(model, cfg, x, logits_last_only)
    if not carry:
        return logits, None
    if inplace:
        return logits, st
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


@full_float32()
def forward(model: RecurrentLM, cfg: MambaConfig, tokens: torch.Tensor,
            state: dict[str, torch.Tensor] | None = None,
            logits_last_only: bool = False, valid: torch.Tensor | None = None,
            impl: str = "auto", inplace: bool = False,
            hold: torch.Tensor | None = None):
    """(logits (B, T or 1, V) float32, new state).  ``state=None`` runs
    from zeros and returns None; a given state carries the recurrence
    (prefill, then decode steps).  ``valid`` (B, T) bool marks the real
    tokens of a left-padded batch; ``inplace`` writes the new state into
    ``state``'s tensors (and returns it), except the rows ``hold`` (B,)
    marks, which keep theirs."""
    def mixer(i, h, conv_s, ssm_s):
        return _mamba_mix(model.layers, i, cfg, h, conv_s, ssm_s,
                          valid=valid, impl=impl)
    return _run(model, cfg, tokens, state, logits_last_only, inplace, hold,
                mixer)


@full_float32()
def forward2(model: RecurrentLM, cfg: Mamba2Config, tokens: torch.Tensor,
             state: dict[str, torch.Tensor] | None = None,
             logits_last_only: bool = False, valid: torch.Tensor | None = None,
             impl: str = "auto", inplace: bool = False,
             hold: torch.Tensor | None = None):
    """The standalone Mamba2 LM (codestral-mamba-style checkpoints); as
    :func:`forward`.  ``impl="dequant"`` is the float-dequant reference."""
    md = cfg.dims()
    layers = model.layers

    def mixer(i, h, conv_s, ssm_s):
        zxbcdt = ternary_matmul(h, layers.proj("in_proj", i), impl=impl)
        y, new_conv, new_ssm = mamba2_core(zxbcdt, conv_s, ssm_s,
                                           layers.layer(i), md, valid=valid)
        out = ternary_matmul(y.to(h.dtype), layers.proj("out_proj", i),
                             impl=impl)
        return out, new_conv, new_ssm
    return _run(model, cfg, tokens, state, logits_last_only, inplace, hold,
                mixer)


def make_generate_fn(cfg: MambaConfig, n_steps: int):
    """Greedy generation: one prefill, then ``n_steps - 1`` one-token
    recurrent steps; f(model, tokens (B, T)) -> (B, n_steps) tokens."""

    @torch.inference_mode()
    def generate(model: RecurrentLM, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.to(model.device)
        state = init_state(cfg, tokens.shape[0], model.device)
        logits, state = forward(model, cfg, tokens, state,
                                logits_last_only=True, inplace=True)
        last = logits[:, 0, :cfg.vocab_size].argmax(-1)
        out = [last]
        for _ in range(n_steps - 1):
            logits, state = forward(model, cfg, last[:, None], state,
                                    inplace=True)
            last = logits[:, 0, :cfg.vocab_size].argmax(-1)
            out.append(last)
        return torch.stack(out, 1)

    return generate
