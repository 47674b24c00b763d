"""The handover of tests/test_torch_loop.py through the plateau policy: the
JAX epoch-0 checkpoint's meta is rewritten so that no epoch can improve on
its loss (0.0) and one stale epoch is already counted; with
``lr_decay_every`` 1 and ``max_epochs_since_improvement`` 2 both packages
then log "DECAYING learning rate to ...", train epoch 1, log "Epochs since
last improvement: 2" and stop early before epoch 2.  Tolerances as in
tests/test_torch_loop.py.
"""

import dataclasses
import json

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_tpu.train import loop as jloop
from test_torch_common import port_config, tmp_dir, train_split  # noqa: F401
from test_torch_loop import assert_same_state, read_jax, resume_both, strip_timing


def test_decay_and_early_stop_continue_where_jax_does(tmp_dir):
    from flax import serialization

    jc, _, out, wm = train_split(tmp_dir, dropout=False)
    jloop.train(jc, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp_dir / "jax"),
                max_epochs=1, log=lambda s: None)
    payload = read_jax(tmp_dir / "jax" / "checkpoint_0_tiny_geo.msgpack")
    meta = json.loads(payload["meta"])
    payload["meta"] = json.dumps(dict(meta, loss=0.0, epochs_since_improvement=1))
    stale = tmp_dir / "stale_checkpoint_0_tiny_geo.msgpack"
    stale.write_bytes(serialization.msgpack_serialize(payload))

    jc = jc.replace(train=dataclasses.replace(jc.train, lr_decay_every=1,
                                              max_epochs_since_improvement=2))
    jlines, tlines, j, t = resume_both(tmp_dir, jc, port_config(jc), out, wm,
                                       str(stale), max_epochs=4)
    assert strip_timing(tlines) == strip_timing(jlines)
    lr = jc.train.decoder_lr * jc.train.lr_decay_factor
    assert tlines[1] == f"DECAYING learning rate to {lr:.6f}"
    assert tlines[-1] == "Epochs since last improvement: 2"
    assert not any(s.startswith("Epoch: [2]") for s in tlines)     # the early stop
    assert json.loads(t["meta"])["epochs_since_improvement"] == 2
    assert_same_state(j, t, payload["params"], lr)
