"""``Engine(mesh=)`` against the JAX package's mesh engine on the CPU.

The port's engine runs tiny_real in gloo ranks (``tests/_torch_parallel.
py:engine_tokens``: 4 slots, ctx 256, six greedy requests of 12 tokens) at
tp 2, dp 2 and dp 2 x tp 2; the JAX engine serves the same checkpoint and
requests in this process on its virtual CPU mesh with
``impl="pallas_interpret"``, as the port's engine tests run it.  Greedy
tokens must be equal at each mesh shape.

Against the single-device engine: on a mesh both packages take the
unfused wo and FFN (the JAX gates fuse them only without a tp axis) and
the sharded sub-norm sums, so the second request's logits there move by
about 3e-2 and its fifth token, 0.024 ahead of the next on one device,
changes in both packages alike.  The test holds that the port's mesh
tokens equal its single-device tokens exactly where the JAX mesh engine's
equal the JAX single-device engine's, and differ where they differ.
"""

import functools
import pathlib

import pytest

from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import ssm as jssm
from vlut_tpu.models.transformer import init_params as jax_init
from vlut_tpu.config import ModelConfig as JaxConfig
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.parallel.sharding import make_mesh
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.parallel.distributed import launch

import _torch_parallel as worker

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
MESHES = [(1, 2), (2, 1), (2, 2)]


@functools.cache
def _jax_tokens(dp: int, tp: int) -> list:
    cfg, params, _ = jax_load(TINY_REAL)
    mesh = make_mesh(dp=dp, tp=tp) if dp * tp > 1 else None
    eng = JaxEngine(cfg, params, n_slots=4, max_len=256,
                    impl="pallas_interpret", fuse=False, mesh=mesh)
    reqs = [JaxRequest(prompt=[2] + list(t), max_new_tokens=12,
                       sampler=JaxSampler(temperature=0.0))
            for t in worker.TEXTS]
    eng.run(reqs)
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    groups = {2: [("engine_tokens", (1, 2)), ("engine_tokens", (2, 1))],
              4: [("engine_tokens", (2, 2)), ("engine_refusals", ())]}
    return {n: launch("_torch_parallel:run_cases", (cases,), nprocs=n,
                      timeout=300, folder=tmp_path_factory.mktemp(f"w{n}"))
            for n, cases in groups.items()}


def _port(ranks, dp, tp):
    return {(1, 2): ranks[2][0][0], (2, 1): ranks[2][0][1],
            (2, 2): ranks[4][0][0]}[(dp, tp)]


@functools.cache
def _port_single() -> list:
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    eng = Engine(cfg, model, n_slots=4, max_len=256)
    reqs = [Request(prompt=[2] + list(t), max_new_tokens=12,
                    sampler=SamplerParams(temperature=0.0))
            for t in worker.TEXTS]
    eng.run(reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_tokens_equal_jax_mesh(ranks, dp, tp):
    got = _port(ranks, dp, tp)
    assert got["outputs"] == _jax_tokens(dp, tp)
    # each rank holds its dp group's slots and its tp share of KV heads
    assert got["cache_k"][:1] == (4 // dp,)
    assert got["cache_k"][2] == 2 // tp


@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_tokens_agree_with_single_device_as_jax_does(ranks, dp, tp):
    port_mesh, port_one = _port(ranks, dp, tp)["outputs"], _port_single()
    jax_mesh, jax_one = _jax_tokens(dp, tp), _jax_tokens(1, 1)
    assert port_one == jax_one
    for pm, po, jm, jo in zip(port_mesh, port_one, jax_mesh, jax_one):
        assert (pm == po) == (jm == jo)
    assert sum(pm == po for pm, po in zip(port_mesh, port_one)) >= 5


@functools.cache
def _jax_refusals() -> list[str]:
    """The JAX engine's messages for the cases of
    ``_torch_parallel.engine_refusals``, in its order."""
    mesh = make_mesh(dp=2, tp=2)
    cfg = JAX_PRESETS["tiny"]
    params = jax_init(cfg, seed=0)
    m_cfg = jssm.MambaConfig(vocab_size=96, d_model=64, n_layers=1,
                             d_state=8)
    mla = JAX_PRESETS["tiny_mla"]
    moe = JaxConfig(arch="llama", vocab_size=256, d_model=128, n_layers=2,
                    n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
                    n_experts=3, n_experts_used=2, tp_pack=1)
    heads = JaxConfig(arch="llama", vocab_size=256, d_model=128, n_layers=1,
                      n_heads=2, n_kv_heads=1, d_ff=128, max_seq_len=128)
    pack = JaxConfig(arch="llama", vocab_size=256, d_model=128, n_layers=1,
                     n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
                     tp_pack=1)
    cases = [
        lambda: JaxEngine(cfg, params, n_slots=3, max_len=64, mesh=mesh),
        lambda: JaxEngine(cfg, params, n_slots=4, max_len=64, mesh=mesh,
                          lookahead=(4, 3)),
        lambda: JaxEngine(cfg, params, n_slots=4, max_len=64, mesh=mesh,
                          draft=(cfg, params)),
        lambda: JaxEngine(m_cfg, jssm.init_params(m_cfg, seed=0), n_slots=4,
                          mesh=mesh),
        lambda: JaxEngine(mla, jax_init(mla, seed=0), n_slots=4, max_len=64,
                          mesh=mesh),
        lambda: JaxEngine(moe, jax_init(moe, seed=0), n_slots=4, max_len=64,
                          mesh=mesh),
        lambda: JaxEngine(heads, jax_init(heads, seed=0), n_slots=4,
                          max_len=64, mesh=mesh),
        lambda: JaxEngine(pack, jax_init(pack, seed=0), n_slots=4,
                          max_len=64, mesh=mesh),
    ]
    out = []
    for fn in cases:
        with pytest.raises(ValueError) as e:
            fn()
        out.append(str(e.value))
    return out


REFUSALS = ["n_slots", "lookahead", "draft", "recurrent", "mla", "experts",
            "heads", "tp_pack"]


@pytest.mark.parametrize("i", range(len(REFUSALS)), ids=REFUSALS)
def test_mesh_refusals_match_jax(ranks, i):
    want = _jax_refusals()[i]
    assert ranks[4][0][1][i] == want
    # every rank refuses alike
    assert all(r[1][i] == want for r in ranks[4])

