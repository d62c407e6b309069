"""``bench/hf_writer.py``'s float families: a random tree of each family
(``bench/recurrent_zoo.py`` / ``bench/encoder_zoo.py``, in the converters'
layouts) written as an HF directory converts back to itself with both
converters (the port on the CPU): the same config, and every leaf of the
checkpoint the tree's, bit for bit.
"""

import pathlib

import pytest
import torch

pytest.importorskip("transformers")

from _torch_convert import convert_both  # noqa: E402

from vlut_tpu_torch.bench import encoder_zoo, hf_writer, recurrent_zoo  # noqa: E402,E501
from vlut_tpu_torch.convert.checkpoint import read_tree  # noqa: E402

FAMILIES = {"rwkv7": recurrent_zoo, "lfm2": recurrent_zoo,
            "jamba": recurrent_zoo, "bert": encoder_zoo,
            "t5_gated": encoder_zoo, "t5_relu": encoder_zoo,
            "gemma3n": encoder_zoo}


def _leaves(node, key=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{key}.{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{key}.{i}")
    else:
        yield key, node


def written_back(cfg, tree, out: pathlib.Path) -> None:
    """The checkpoint in ``out`` holds ``tree``, leaf for leaf, bit for bit,
    and ``cfg``."""
    got_cfg, got, _ = read_tree(out)
    assert got_cfg == cfg
    want = dict(_leaves(tree))
    have = dict(_leaves(got))
    assert sorted(want) == sorted(have)
    for k, w in want.items():
        g = have[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("name", list(FAMILIES))
def test_written_family_converts_back(name, tmp_path):
    cfg, tree = FAMILIES[name].family(name, seed=3)
    src = hf_writer.write_hf(tmp_path / "hf", cfg, tree,
                             tokenizer_src=pathlib.Path(__file__).parent
                             / "fixtures" / "tiny_real")
    out = convert_both(src, tmp_path, config=False)
    written_back(cfg, tree, out)


def test_family_writer_refuses_other_layouts(tmp_path):
    cfg, tree = recurrent_zoo.family("rwkv7")
    with pytest.raises(ValueError, match="float32"):
        hf_writer.write_hf(tmp_path / "a", cfg, tree, layout="hf1bitllm")
    cfg, tree = recurrent_zoo.family("plamo2")
    with pytest.raises(ValueError, match="lfm2 or jamba"):
        hf_writer.write_hf(tmp_path / "b", cfg, tree)
