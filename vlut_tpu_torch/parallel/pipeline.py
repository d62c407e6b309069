"""Pipeline parallelism: layer stages and a GPipe schedule (port of
vlut_tpu/parallel/pipeline.py).

The layer stack's L dim splits over a "pp" mesh axis, each stage holding
L / pp consecutive layers (:func:`stage_params`); the embedding, the final
norm and the head stay whole on every stage.  :func:`make_forward_pp` runs
M microbatches through the stages: at schedule step s stage i runs
microbatch s - i and hands its output to stage i + 1 (``ppermute``), the
last stage collects the outputs, and their sum over the axis gives every
stage the logits.  A stage skips the layers at the steps where it holds no
microbatch (the JAX program runs them on a clamped index and drops the
result); the hand-offs run at every step, as there.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.transformer import (
    StackedLayers,
    TransformerLM,
    run_layers,
)
from vlut_tpu_torch.ops import norm as nrm
from vlut_tpu_torch.ops.quant import true_div
from vlut_tpu_torch.parallel._comm import ppermute, psum
from vlut_tpu_torch.parallel.sharding import Mesh


def _stage_range(cfg: ModelConfig, mesh: Mesh) -> tuple[int, int]:
    pp = mesh.shape["pp"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    n = cfg.n_layers // pp
    return mesh.coords["pp"] * n, n


def stage_params(params: TransformerLM, mesh: Mesh,
                 cfg: ModelConfig) -> TransformerLM:
    """This stage's model: the same top-level tensors, and only its layers
    (copies of them on the mesh's device)."""
    first, n = _stage_range(cfg, mesh)
    layers = params.layers
    if isinstance(layers, StackedLayers):
        tree = {k: (v[first:first + n].clone() if not isinstance(v, dict)
                    else {a: t[first:first + n].clone()
                          for a, t in v.items()})
                for k, v in layers.tree().items()}
        local = StackedLayers(tree, layers._specs, n)
    else:
        local = nn.ModuleList(copy.deepcopy(layers[first + j])
                              for j in range(n))
    stage = copy.copy(params)
    stage._modules = dict(params._modules)
    stage._modules["layers"] = local
    return stage.to(mesh.device)


def make_forward_pp(cfg: ModelConfig, mesh: Mesh, n_microbatches: int = 2):
    """f(params, tokens, positions) -> (B, T, vocab_p) logits, cache-less
    (scoring / prefill), pipelined over the "pp" axis; ``params`` this
    stage's model (:func:`stage_params`), ``tokens`` and ``positions``
    every row.  B must divide by ``n_microbatches``."""
    pp = mesh.shape["pp"]
    first, _ = _stage_range(cfg, mesh)
    stage = mesh.coords["pp"]
    group = mesh.group("pp")
    m_mb = n_microbatches

    @full_float32()
    def fwd(params, tokens, positions):
        b, t = tokens.shape
        if b % m_mb:
            raise ValueError(f"batch {b} not divisible by microbatches "
                             f"{m_mb}")
        x = params.embed[tokens]
        if cfg.embed_scale:
            x = (x.to(torch.float32) * cfg.embed_scale).to(x.dtype)
        mb = b // m_mb
        xs = x.reshape(m_mb, mb, t, x.shape[-1])
        pos_mb = positions.reshape(m_mb, mb, t)
        state = torch.zeros((mb, t, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
        outs = torch.zeros((m_mb, mb, t, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
        perm = [(i, i + 1) for i in range(pp - 1)]
        for s in range(m_mb + pp - 1):
            i_mb = s - stage  # the microbatch this stage holds at step s
            if 0 <= i_mb < m_mb:
                inp = xs[i_mb] if stage == 0 else state
                y, _ = run_layers(params, inp, pos_mb[i_mb], None, cfg=cfg,
                                  first_layer=first)
                if stage == pp - 1:
                    outs[i_mb] = y
            else:
                y = torch.zeros_like(state)
            if pp > 1:
                state, = ppermute((y,), group, perm)
        # the last stage's outputs, on every stage
        outs = psum(outs if stage == pp - 1 else torch.zeros_like(outs),
                    group)
        h = nrm.rms(outs.reshape(b, t, -1), params.final_norm, cfg.rms_eps,
                    cfg.d_model, cfg.norm_plus_one)
        head = (params.lm_head if hasattr(params, "lm_head")
                else params.embed.T)
        logits = h.to(torch.float32) @ head.to(torch.float32)
        if cfg.final_logit_softcap:
            cap = cfg.final_logit_softcap
            logits = cap * torch.tanh(true_div(logits, cap))
        return logits

    return fwd
