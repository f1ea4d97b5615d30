"""UMT5 (WAN's text encoder) from an HF ``UMT5EncoderModel`` state dict:
``models.convert.umt5_state_dict_from_hf`` into the port's ``T5Encoder`` at
``per_layer_rel_bias=True``, against ``transformers.UMT5EncoderModel`` and
the JAX ``T5Encoder`` over ``convert_umt5_encoder``.

A tiny 2-layer UMT5 (the JAX test's shape: 8 buckets, distance 20, gated
gelu) with random weights; ids padded and masked. Tolerances: the JAX test's
1e-4 against HF, and 1e-5 against the JAX encoder (both fp32, the same
products); the converted tensors bitwise the JAX tree's carried across. The
shared-bias ``t5_state_dict_from_hf`` must refuse such a state (the tables
of blocks 1.. are not consumed), as the JAX
``test_shared_bias_t5_rejects_umt5_state`` requires of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models import t5 as t_t5
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models import t5 as j_t5
from chip_smoke import hf_umt5_state_dict
from tests.test_mirror_parity import randomize

transformers = pytest.importorskip("transformers")

CFG = dict(vocab_size=101, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
           relative_attention_num_buckets=8, relative_attention_max_distance=20)
IDS = np.array([[3, 4, 5, 6, 1, 0, 0, 0], [7, 8, 1, 0, 0, 0, 0, 0]])


@pytest.fixture(scope="module")
def hf_umt5():
    torch.manual_seed(0)
    model = transformers.UMT5EncoderModel(transformers.UMT5Config(
        feed_forward_proj="gated-gelu", dropout_rate=0.0, is_encoder_decoder=False,
        **CFG)).eval()
    return randomize(model, seed=11, std=0.1)


def _port(sd):
    model = t_t5.T5Encoder(t_t5.T5Config(dtype=torch.float32, per_layer_rel_bias=True, **CFG))
    model.load_state_dict(t_convert.umt5_state_dict_from_hf(sd, CFG["num_layers"]))
    return model.eval()


def test_writer_names_are_hf(hf_umt5):
    """``chip_smoke.hf_umt5_state_dict`` of the port's UMT5 gives the HF
    model's names and shapes, less the tied ``encoder.embed_tokens.weight``
    that ``save_pretrained`` leaves out; and it converts back bitwise."""
    sd = hf_umt5.state_dict()
    port = _port(sd)
    written = hf_umt5_state_dict(port.state_dict())
    want = {k: tuple(v.shape) for k, v in sd.items() if k != "encoder.embed_tokens.weight"}
    assert {k: tuple(v.shape) for k, v in written.items()} == want
    back = t_convert.umt5_state_dict_from_hf(written, CFG["num_layers"])
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_umt5_matches_hf_and_jax(hf_umt5, masked):
    """The converted encoder against HF's on the valid positions (1e-4) and
    against the JAX ``T5Encoder`` over ``convert_umt5_encoder`` everywhere
    (1e-5); the two converters' trees equal bitwise."""
    sd = hf_umt5.state_dict()
    port = _port(sd)
    jparams = j_convert.convert_umt5_encoder({k: v.numpy() for k, v in sd.items()},
                                             CFG["num_layers"])
    tcfg = port.cfg
    carried = t_convert.t5_state_dict_from_jax(jparams, tcfg)
    assert all(torch.equal(carried[k], v) for k, v in port.state_dict().items())
    mask = IDS != 0 if masked else np.ones_like(IDS, bool)
    with torch.no_grad():
        got = port(torch.from_numpy(IDS), torch.from_numpy(mask)).numpy()
        ref = hf_umt5(torch.from_numpy(IDS),
                      attention_mask=torch.from_numpy(mask.astype(np.int64))).last_hidden_state
    jcfg = j_t5.T5Config(dtype=jnp.float32, per_layer_rel_bias=True, **CFG)
    want = j_t5.T5Encoder(jcfg).apply({"params": jax.tree_util.tree_map(jnp.asarray, jparams)},
                                      jnp.asarray(IDS), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    valid = mask if masked else slice(None)
    np.testing.assert_allclose(got[valid], ref.numpy()[valid], atol=1e-4)


def test_shared_bias_converter_refuses_a_umt5_state(hf_umt5):
    """``t5_state_dict_from_hf`` (one table, block 0's) on a UMT5 state
    raises "not consumed" for the other blocks' tables."""
    with pytest.raises(ValueError, match="not consumed.*block.1.*relative_attention_bias"):
        t_convert.t5_state_dict_from_hf(hf_umt5.state_dict(), CFG["num_layers"])


@pytest.mark.parametrize("defect", ["leftover", "missing_table", "missing_ffn"])
def test_umt5_converter_is_strict(hf_umt5, defect):
    """A weight left over raises "not consumed"; a missing one (block 1's bias
    table, a feed-forward matrix) raises naming it."""
    sd = dict(hf_umt5.state_dict())
    if defect == "leftover":
        sd["encoder.block.2.layer.0.layer_norm.weight"] = torch.ones(CFG["d_model"])
        with pytest.raises(ValueError, match="not consumed"):
            t_convert.umt5_state_dict_from_hf(sd, CFG["num_layers"])
        return
    name = ("encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight"
            if defect == "missing_table" else "encoder.block.0.layer.1.DenseReluDense.wi_1.weight")
    del sd[name]
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        t_convert.umt5_state_dict_from_hf(sd, CFG["num_layers"])
