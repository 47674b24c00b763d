"""The port's roofline (icek_torch/utils/roofline.py): every FLOP and byte
model equals the JAX package's (icek_tpu/utils/roofline.py) at the three
presets' shapes, exactly (integer arithmetic); the H100's peaks come from
the card's name."""

import dataclasses

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch.core import config as tcfg
from icek_torch.utils import roofline as troof
from icek_tpu.core import config as jcfg
from icek_tpu.utils import roofline as jroof

# (entity rows, fact rows, train caption length): benchmarks/train_throughput.py
SHAPES = {"georic": (301, 0, 32), "k_georic": (301, 51, 102), "nytimes800k": (101, 301, 52)}
VOCAB, BEAM = 10000, 5


@pytest.mark.parametrize("preset", sorted(SHAPES))
def test_every_model_equals_jax(preset):
    E, F, T = SHAPES[preset]
    jm, tm = jcfg.get_config(preset).model, tcfg.get_config(preset).model
    L = tcfg.get_config(preset).decode.max_caption_len
    d, ffn = tm.emb_dim, tm.decoder_ffn_dim
    for size in (224, 256):
        assert troof.resnet101_encode_flops(size, d) == jroof.resnet101_encode_flops(size, d)
        assert troof.resnet101_encode_bytes(size) == jroof.resnet101_encode_bytes(size)
    assert troof.encoder_layer_flops(E, d, ffn) == jroof.encoder_layer_flops(E, d, ffn)
    assert (troof.decoder_layer_flops(T, 196 + E + F, d, ffn)
            == jroof.decoder_layer_flops(T, 196 + E + F, d, ffn))
    assert (troof.copy_scores_flops(T, d, VOCAB, E, F, tm.num_predicates)
            == jroof.copy_scores_flops(T, d, VOCAB, E, F, jm.num_predicates))
    assert (troof.captioner_forward_flops(tm, VOCAB, E, F, T)
            == jroof.captioner_forward_flops(jm, VOCAB, E, F, T))
    assert troof.train_step_flops(tm, VOCAB, E, F, T) == jroof.train_step_flops(
        jm, VOCAB, E, F, T)
    for t in (1, L // 2, L):
        assert (troof.decode_step_flops(tm, VOCAB, E, F, t)
                == jroof.decode_step_flops(jm, VOCAB, E, F, t))
        for beam in (1, BEAM):
            assert (troof.decode_step_bytes(tm, E, F, t, beam=beam)
                    == jroof.decode_step_bytes(jm, E, F, t, beam=beam))
    assert (troof.eval_pipeline_costs(tm, VOCAB, E, F, BEAM, L)
            == jroof.eval_pipeline_costs(jm, VOCAB, E, F, BEAM, L))


def test_a_narrower_geometry_equals_jax():
    tm = dataclasses.replace(tcfg.georic().model, emb_dim=256, num_heads=8)
    jm = dataclasses.replace(jcfg.georic().model, emb_dim=256, num_heads=8)
    assert (troof.eval_pipeline_costs(tm, VOCAB, 301, 0, BEAM, 30)
            == jroof.eval_pipeline_costs(jm, VOCAB, 301, 0, BEAM, 30))


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)), ("NVIDIA H100 PCIe", (989e12, 3.35e12)),
    ("NVIDIA A100-SXM4-80GB", None), ("", None),
])
def test_chip_peaks_by_card_name(name, want, monkeypatch):
    monkeypatch.setattr(troof, "device_name", lambda device=None: name)
    assert troof.chip_peaks() == want


def test_utilization(monkeypatch):
    monkeypatch.setattr(troof, "device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    u = troof.utilization(989e12 * 0.25, 1.0, hbm_bytes=3.35e12 * 0.5)
    assert u == {"chip": "NVIDIA H100 80GB HBM3", "mfu_pct": 25.0, "hbm_util_pct": 50.0}
    assert "hbm_util_pct" not in troof.utilization(1e12, 1.0)
    assert troof.utilization(1e12, 0.0) == {}
    monkeypatch.setattr(troof, "device_name", lambda device=None: "")
    assert troof.utilization(1e12, 1.0) == {}
    if not torch.cuda.is_available():
        monkeypatch.undo()
        assert troof.device_name() == "" and troof.chip_peaks() is None
