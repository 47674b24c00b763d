"""The import of torch weights into the port's trees
(icek_torch/train/port.py) and the GloVe loader (icek_torch/train/embeddings.py)
against icek_tpu's, the counterparts of tests/test_encoder_weights.py:61 /
:113 and tests/test_model_parity.py::test_reference_pth_tar_checkpoint_port.
The port's trees are held to JAX's through bridge.py: bit for bit, except a
fresh projection, which each package draws from its own generator.  The
reference repository is not mounted, so the reference-style checkpoint is
built here: whole pickled modules whose state_dicts carry the reference's
names.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import bridge
from icek_torch.models import resnet as tres
from icek_torch.train import checkpoint as tckpt
from icek_torch.train import port as tport
from icek_tpu.train import checkpoint as jckpt
from icek_tpu.train import port as jport
from test_encoder_weights import _randomize_bn_buffers, torchvision_state_dict
from test_model_parity import TinyEncoder, build_torch_resnet101_body, torch_seed
from test_torch_common import (fact_cfgs, jax_params_numpy, removed_after,  # noqa: F401
                               small_cfgs, tmp_dir)
from test_torch_loop import at, tree_paths

EMB = 20


@pytest.fixture(scope="module")
def torch_body():
    torch_seed(11)
    body = build_torch_resnet101_body()
    _randomize_bn_buffers(body)
    return body


@pytest.fixture(scope="module")
def pth(torch_body, tmp_path_factory):
    for tmp in removed_after(tmp_path_factory, "weights"):
        path = tmp / "resnet101-imagenet.pth"
        torch.save(torchvision_state_dict(torch_body), path)
        yield str(path)


def _bit_equal(port_tree, jax_tree, resnet=True, skip=()):
    want = bridge.from_jax_resnet(jax.tree.map(np.asarray, jax_tree)) if resnet else \
        bridge.to_torch(jax.tree.map(np.asarray, jax_tree))
    got, exp = dict(tree_paths(port_tree)), dict(tree_paths(want))
    assert got.keys() == exp.keys()
    for path, w in exp.items():
        if path[0] in skip:
            assert got[path].shape == w.shape, path
            continue
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path


def test_torchvision_weights_encode_as_the_torch_oracle(pth, torch_body, tmp_dir):
    """A torchvision-named state_dict .pth -> the port's encoder tree (body
    bit-equal to JAX's import, a fresh projection) -> an encoder-tree file
    -> tokens that match the torch body + the same projection."""
    tree = tport.load_torchvision_encoder(pth, EMB, seed=7)
    _bit_equal(tree, jport.load_torchvision_encoder(pth, EMB, seed=7), skip=("proj",))
    assert tree["proj"]["w"].shape == (EMB, 2048, 1, 1)
    assert tree["proj"]["w"].abs().max() > 0                   # drawn, never zeros
    assert torch.equal(tree["proj"]["w"],
                       tres.init_proj(torch.Generator().manual_seed(7), EMB)["w"])
    path = tckpt.save_encoder_tree(str(tmp_dir / "encoder.pt"), tree, {"emb_dim": EMB})
    tree, meta = tckpt.load_encoder_tree(path)
    assert meta == {"emb_dim": EMB}

    oracle = TinyEncoder(emb_dim=EMB).eval()
    oracle.resnet.load_state_dict(torch_body.state_dict())
    with torch.no_grad():
        oracle.conv1.weight.copy_(tree["proj"]["w"])
        oracle.conv1.bias.copy_(tree["proj"]["b"])
        image = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (1, 64, 64, 3)).astype(np.float32))
        want = oracle(image.permute(0, 3, 1, 2)).permute(0, 2, 1)
        got = tres.resnet_encode(tree, image, encoded_size=14)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)


def test_resolver_accepts_pth_and_full_checkpoints(pth, tmp_dir):
    """--encoder-weights takes the raw .pth (the same tree as the direct
    import), an encoder tree or full checkpoint of either package (its
    encoder_params); a file that carries a projection of another width
    raises, a bare body gets a fresh one of any width."""
    direct = tport.resolve_encoder_weights(pth, EMB, seed=7)
    via = tport.load_torchvision_encoder(pth, EMB, seed=7)
    for path, w in tree_paths(via):
        assert torch.equal(at(direct, path), w), path
    jtree = jport.resolve_encoder_weights(pth, EMB, seed=7)
    _bit_equal(direct, jtree, skip=("proj",))

    pt_ckpt = tckpt.save_checkpoint(str(tmp_dir), "ckpt_form", 0, 0, 1.0,
                                    {"w": torch.zeros(2)}, None, direct)
    j_ckpt = jckpt.save_checkpoint(str(tmp_dir), "ckpt_form", 0, 0, 1.0,
                                   {"w": np.zeros(2)}, None, jtree)
    assert pt_ckpt.endswith(".pt") and j_ckpt.endswith(".msgpack")
    _bit_equal(tport.resolve_encoder_weights(pt_ckpt, EMB), jtree, skip=("proj",))
    _bit_equal(tport.resolve_encoder_weights(j_ckpt, EMB), jtree)

    wide = tport.resolve_encoder_weights(pth, EMB + 1, seed=7)
    assert wide["proj"]["w"].shape[0] == EMB + 1
    tree_path = tckpt.save_encoder_tree(str(tmp_dir / "tree.pt"), direct)
    for path in (tree_path, pt_ckpt, j_ckpt):
        with pytest.raises(ValueError, match="emb_dim"):
            tport.resolve_encoder_weights(path, EMB + 1)


def _reference_state(tree, cfg):
    """The reference DecoderTransformer's state_dict names for a captioner
    tree (the inverse of import_captioner_state): linear weights (out, in),
    MHA in_proj_weight (3D, D)."""
    state = {"word_embedding.weight": tree["word_embedding"],
             "entity_encoder.type_embedding.weight": tree["type_embedding"]}

    def linear(prefix, p):
        state[prefix + ".weight"] = p["w"].T.copy()
        state[prefix + ".bias"] = p["b"]

    def mha(prefix, p):
        state[prefix + ".in_proj_weight"] = p["qkv_w"].T.copy()
        state[prefix + ".in_proj_bias"] = p["qkv_b"]
        linear(prefix + ".out_proj", p["out"])

    def stack(prefix, layers, names):
        for i, layer in enumerate(layers):
            p = f"{prefix}.layers.{i}"
            mha(p + ".self_attn", layer["self_attn"])
            if "cross_attn" in layer:
                mha(p + ".multihead_attn", layer["cross_attn"])
            linear(p + ".linear1", layer["ffn"]["lin1"])
            linear(p + ".linear2", layer["ffn"]["lin2"])
            for n in names:
                state[f"{p}.{n}.weight"] = layer[n]["scale"]
                state[f"{p}.{n}.bias"] = layer[n]["bias"]

    stack("transformer_encoder_entities", tree["ctx_encoder_entities"]["layers"],
          ("norm1", "norm2"))
    stack("transformer_decoder", tree["decoder"]["layers"], ("norm1", "norm2", "norm3"))
    linear("fc_vocab", tree["fc_vocab"])
    linear("fc_entity", tree["fc_entity"])
    if cfg.has_facts:
        state["predicate_embedding.weight"] = tree["predicate_embedding"]
        stack("transformer_encoder_facts", tree["ctx_encoder_facts"]["layers"],
              ("norm1", "norm2"))
        linear("fc_fact", tree["fc_fact"])
        linear("fc_predicate", tree["fc_predicate"])
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in state.items()}


class ReferenceDecoder(torch.nn.Module):
    """A pickled stand-in for the reference's DecoderTransformer: a module
    whose state_dict carries the reference's parameter names."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def state_dict(self, *a, **k):
        return dict(self.state)


@pytest.mark.parametrize("variant", ["geo", "knowledge"])
def test_reference_pth_tar_checkpoint_port(tmp_dir, variant):
    """A reference-style .pth.tar (whole pickled modules, geo utils.py:32-49)
    gives the same captioner and encoder trees and meta in both packages."""
    if variant == "geo":
        jc, tc = small_cfgs(emb_dim=8, num_heads=2, ffn=12, layers=2, type_vocab=6)
    else:
        jc, tc = fact_cfgs("knowledge", emb_dim=12, ffn=12, num_predicates=5)
    tree = jax_params_numpy(jc.model, 25, 3)
    torch_seed(9)
    encoder = TinyEncoder(emb_dim=jc.model.emb_dim).eval()
    path = tmp_dir / f"checkpoint_4_{variant}.pth.tar"
    torch.save({"epoch": 4, "epochs_since_improvement": 1, "loss": 3.21,
                "encoder": encoder, "decoder": ReferenceDecoder(_reference_state(tree, jc.model)),
                "encoder_optimizer": None, "decoder_optimizer": None}, path)
    params, enc, meta = tport.load_reference_checkpoint(str(path), tc.model)
    jparams, jenc, jmeta = jport.load_reference_checkpoint(str(path), jc.model)
    assert meta == jmeta == {"epoch": 4, "epochs_since_improvement": 1, "loss": 3.21}
    _bit_equal(params, jparams, resnet=False)
    _bit_equal(params, tree, resnet=False)               # the names map back exactly
    _bit_equal(enc, jenc)
    assert enc["proj"]["w"].shape == (jc.model.emb_dim, 2048, 1, 1)
    bridge.from_jax_params(bridge.to_numpy(params), tc.model, 25)     # shapes check


def test_glove_loader_matches_jax(tmp_path):
    from icek_torch.data.codec import Wordmap as TWordmap
    from icek_torch.train.embeddings import load_glove_embeddings as tload
    from icek_tpu.data.codec import Wordmap as JWordmap
    from icek_tpu.train.embeddings import load_glove_embeddings as jload

    words = ["bridge", "river", "tower", "old", "unseen"]
    rng = np.random.default_rng(0)
    lines = [f"{w} " + " ".join(f"{v:.6f}" for v in rng.standard_normal(4))
             for w in ("river", "bridge", "zebra", "tower")]
    lines.append("old 1.0 2.0")                       # the wrong width: skipped
    lines.append("tower  " + " ".join(["0.5"] * 4) + " ")   # extra spaces
    path = tmp_path / "glove.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    mapping = JWordmap.from_words(words).word_to_id
    got = tload(str(path), TWordmap(mapping), 4, seed=3)
    want = jload(str(path), JWordmap(mapping), 4, seed=3)
    assert got.dtype == np.float32 and got.shape == (len(mapping), 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[mapping["tower"]], np.full(4, 0.5, np.float32))
    bound = np.sqrt(3.0 / 4)
    assert np.abs(got[mapping["unseen"]]).max() <= bound


def test_port_encoder_verb_writes_the_tools_tree(pth, tmp_dir):
    """``python -m icek_torch.apps port-encoder`` writes the encoder tree of
    ``load_torchvision_encoder``, equal to what tools/port_torchvision_encoder.py
    writes (read back through the port's .msgpack reader)."""
    import os
    import sys

    from conftest import REPO_ROOT
    from icek_torch import apps

    out = str(tmp_dir / "enc.pt")
    assert apps.main(["port-encoder", pth, out, "--emb-dim", str(EMB), "--seed", "3"]) == 0
    got, meta = tckpt.load_encoder_tree(out)
    assert meta == {"source": os.path.basename(pth), "emb_dim": EMB, "proj_seed": 3}
    want = tport.load_torchvision_encoder(pth, EMB, 3)
    exp = dict(tree_paths(want))
    assert dict(tree_paths(got)).keys() == exp.keys()
    for path, w in tree_paths(got):
        assert torch.equal(w, exp[path]), path
    if str(REPO_ROOT) not in sys.path:
        sys.path.insert(0, str(REPO_ROOT))
    from tools import port_torchvision_encoder as jtool

    jax_out = str(tmp_dir / "enc.msgpack")
    jtool.main([pth, jax_out, "--emb-dim", str(EMB), "--seed", "3"])
    body, _ = tckpt.load_encoder_tree(jax_out)
    jexp = dict(tree_paths(body))
    for path, w in tree_paths(got):
        if path[0] != "proj":           # JAX draws its fresh projection from its own key
            assert torch.equal(w, jexp[path]), path
